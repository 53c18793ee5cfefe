"""The port's soak package (`fedml_tpu_torch/soak/`, `utils/slo.py`) and
its live loop held against the JAX package's, on the CPU.

- The loadgen schedule (`build_schedule`), the soak knobs
  (`validate_soak` messages, `soak_plan`), the post-hoc SLO verdict
  (`evaluate_slo`) and the live burn-rate monitor (`SloMonitor`) are
  bitwise the JAX modules' on the same inputs.
- The live loop's training tier — `SiloSoakHarness` with the LoRA
  `trainer_factory` over a frozen base, 2 rounds, the JAX trainers' batch
  draws injected — ends at the JAX federation's adapters within 1e-5 of
  the largest update (`tests/test_torch_cross_silo.py`'s rule).
- The loop itself: a chaos run (a server kill, a client kill, a
  mid-stream replica kill) serves with zero non-2xx, converges on the
  last round's version, and its final adapters are bitwise an unkilled
  run's; `from_config` and the refusals behave as in JAX.
"""
import dataclasses
import json
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.cross_silo.soak import SiloSoakHarness as JaxSoakHarness
from fedml_tpu.cross_silo.trainer import SiloTrainer as JaxSiloTrainer
from fedml_tpu.llm.lora import lora_apply_fn as jax_lora_apply_fn
from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.soak import knobs as jax_knobs
from fedml_tpu.soak.loadgen import RequestResult as JaxResult
from fedml_tpu.soak.loadgen import TrafficSpec as JaxTrafficSpec
from fedml_tpu.soak.loadgen import build_schedule as jax_build_schedule
from fedml_tpu.soak.slo import evaluate_slo as jax_evaluate_slo
from fedml_tpu.utils.slo import SloMonitor as JaxSloMonitor
from fedml_tpu.utils.slo import default_specs as jax_default_specs
from fedml_tpu_torch.comm.chaos import FaultSpec
from fedml_tpu_torch.config import Config, TrainArgs
from fedml_tpu_torch.cross_silo.soak import SiloSoakHarness
from fedml_tpu_torch.llm.lora import adapters_from_jax, lora_apply_fn
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.soak import knobs
from fedml_tpu_torch.soak.loadgen import (
    LoadGenerator, RequestResult, TrafficSpec, build_schedule,
)
from fedml_tpu_torch.soak.loop import LiveLoopHarness, lora_trainer_factory
from fedml_tpu_torch.soak.slo import evaluate_slo, percentile
from fedml_tpu_torch.utils import metrics as mx
from fedml_tpu_torch.utils import postmortem
from fedml_tpu_torch.utils.slo import SloMonitor, default_specs

torch.set_num_threads(2)

TOL = 1e-5   # max |param diff| over the largest update, f32, CPU


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())


@pytest.fixture(autouse=True)
def _flight_disarmed():
    """`LiveLoopHarness.run` arms the process's crash flight recorder at
    its artifact root when nothing has (as JAX's does) and leaves it
    armed; disarm it after the test, or a later test's tracked run in
    this process finds it armed and writes no postmortem of its own."""
    armed = postmortem.flight.armed_dir
    yield
    if armed is None and postmortem.flight.armed_dir is not None:
        postmortem.flight.disarm()


# -------------------------------------------------------------- bitwise
SPECS = [dict(seed=7, duration_s=5.0, burst_every_s=2.0, burst_factor=4.0,
              burst_len_s=0.5),
         dict(seed=1, rate_rps=50.0, duration_s=8.0),
         dict(seed=0, vocab=32, rate_rps=6.0, duration_s=40.0,
              stream_frac=0.35, burst_every_s=5.0, burst_factor=6.0,
              burst_len_s=1.0),
         dict(seed=3, vocab=32000, prefix_pool=64, prefix_len=256,
              zipf_s=1.1, suffix_len_med=64.0, suffix_len_max=256,
              out_len_med=48.0, out_len_max=128, rate_rps=2.0,
              duration_s=20.0, stream_frac=0.5, burst_every_s=8.0)]


@pytest.mark.parametrize("kw", SPECS)
def test_build_schedule_bitwise_jax(kw):
    got = build_schedule(TrafficSpec(**kw))
    want = jax_build_schedule(JaxTrafficSpec(**kw))
    assert got and [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    spec = TrafficSpec(**kw)
    assert (spec.max_prompt_len(), spec.max_total_len()) == (
        JaxTrafficSpec(**kw).max_prompt_len(),
        JaxTrafficSpec(**kw).max_total_len())


SOAKS = [{}, {"rounds": 3, "stream_frac": 0.0}, {"rate": 3}, {"rounds": 0},
         {"rounds": 2.5}, {"rounds": True}, {"shed_frac_max": 1.5},
         {"burst_factor": 2.0}, {"burst_every_s": 4, "burst_factor": 2.0,
                                 "burst_len_s": 0.5},
         {"rate_rps": -1}, {"rate_rps": "x"}, {"lag_rounds_max": 0},
         {"slo_error_budget": 0.05, "slo_fast_burn": 3, "seed": 9,
          "n_replicas": 4, "ttft_p99_slo_ms": 900}, [1, 2]]


@pytest.mark.parametrize("sk", SOAKS, ids=[str(i) for i in range(len(SOAKS))])
def test_soak_knobs_equal_jax(sk):
    """validate_soak refuses what JAX refuses, with JAX's message, and
    soak_plan maps what it accepts to JAX's kwargs."""
    assert knobs.SOAK_KNOBS == jax_knobs.SOAK_KNOBS
    try:
        jax_knobs.validate_soak(sk)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            knobs.validate_soak(sk)
        assert str(ei.value) == str(e)
        return
    knobs.validate_soak(sk)
    assert knobs.soak_plan(sk) == jax_knobs.soak_plan(sk)


def test_config_validates_soak_section():
    Config.from_dict({"common_args": {
        "extra": {"soak": {"rounds": 5, "rate_rps": 2.0}}}})
    with pytest.raises(ValueError, match="unknown soak knob"):
        Config.from_dict({"common_args": {"extra": {"soak": {"rateoops": 1}}}})
    with pytest.raises(ValueError, match="must be a positive number"):
        Config.from_dict({"common_args": {"extra": {"soak": {"rate_rps": -1}}}})


def _results(seed, n=300):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        status = int(rs.choice([200, 200, 200, 200, 429, 503, 599]))
        klass = "ok" if status == 200 else (
            "shed" if status == 429 else "error")
        stream = bool(rs.rand() < 0.5)
        out.append(dict(
            status=status, klass=klass, t_sched=float(rs.rand() * 40),
            total_s=float(rs.rand()), stream=stream,
            ttft_s=float(rs.rand() * 3) if stream else None,
            tbt_s=tuple(float(g) for g in rs.rand(int(rs.randint(0, 5))))
            if stream else (), tokens_out=int(rs.randint(0, 9)),
            in_burst=bool(rs.rand() < 0.2)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_slo_equal_jax(seed):
    rows = _results(seed)
    slo = [None, {"shed_frac_max": 0.4, "ttft_p99_slo_ms": 5000.0},
           {"ttft_p99_slo_ms": 500.0, "lag_rounds_max": 1}][seed]
    kw = dict(rounds_done=7, wall_s=21.5, fleet_version=7, lag_max_seen=2,
              publish_lat_s=[0.1, 0.3, 0.2], slo=slo)
    got = evaluate_slo([RequestResult(**r) for r in rows], **kw)
    want = jax_evaluate_slo([JaxResult(**r) for r in rows], **kw)
    assert got == want
    assert mx.snapshot()["gauges"]["soak.slo_ok"] == float(got["slo_ok"])
    assert percentile([], 0.99) is None


class _ScriptedRegistry:
    """A registry whose snapshots are a script, for both packages'
    monitors."""

    def __init__(self, snaps):
        self.snaps = iter(snaps)

    def snapshot(self):
        return next(self.snaps)


def _snaps(seed, n=40):
    rs = np.random.RandomState(seed)
    ok = err = shed = 0
    counts = [0] * 4
    out = []
    for i in range(n):
        ok += int(rs.randint(0, 20))
        err += int(rs.randint(0, 3)) if 10 <= i < 18 else 0
        shed += int(rs.randint(0, 8))
        counts = [c + int(rs.randint(0, 5)) for c in counts]
        out.append({
            "counters": {"loadgen.ok": ok, "loadgen.errors": err,
                         "loadgen.shed": shed},
            "gauges": {"soak.fleet_lag_rounds": float(rs.randint(0, 4))},
            "histograms": {"loadgen.ttft_s": {
                "count": sum(counts), "edges": [0.1, 1.0, 2.5, 5.0],
                "counts": list(counts)}}})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_monitor_verdicts_equal_jax(seed):
    """The same scripted registry and clock through both monitors: every
    tick's burns and alert states, and the firing list, are equal."""
    slo = {"slo_error_budget": 0.02, "shed_frac_max": 0.3,
           "ttft_p99_slo_ms": 2500.0, "lag_rounds_max": 2,
           "slo_fast_burn": 4.0}
    assert [dataclasses.astuple(s) for s in default_specs(slo)] == \
        [dataclasses.astuple(s) for s in jax_default_specs(slo)]
    clock = {"t": 0.0}
    snaps = _snaps(seed)
    mon = SloMonitor(default_specs(slo), fast_window_s=3.0,
                     slow_window_s=12.0, time_fn=lambda: clock["t"],
                     registry=_ScriptedRegistry(snaps))
    jmon = JaxSloMonitor(jax_default_specs(slo), fast_window_s=3.0,
                         slow_window_s=12.0, time_fn=lambda: clock["t"],
                         registry=_ScriptedRegistry(snaps))
    for i in range(len(snaps)):
        clock["t"] = 0.5 * i
        assert mon.sample() == jmon.sample()
    assert mon.firing() == jmon.firing() and mon.firing()
    assert mx.snapshot()["counters"].get("slo.alerts_total", 0) > 0


def test_loadgen_unary_and_stream_against_stub_gateway():
    """The status taxonomy against a stub: 200s are ok, 429s shed, 5xx
    errors; a stream records TTFT and inter-token gaps."""
    calls = {"n": 0}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n))
            calls["n"] += 1
            for every, code in ((5, 429), (7, 503)):
                if calls["n"] % every == 0:
                    self.send_response(code)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for i in range(3):
                    self.wfile.write(b'data: {"token": %d, "index": %d}\n\n'
                                     % (i, i))
                self.wfile.write(b'data: {"done": true}\n\n')
            else:
                out = json.dumps({"generated_tokens":
                                  [1] * body["max_new_tokens"]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        gen = LoadGenerator(
            TrafficSpec(seed=2, rate_rps=60.0, duration_s=0.6,
                        stream_frac=0.4),
            f"http://127.0.0.1:{srv.server_address[1]}/predict").start()
        gen.done.wait(10)
        results = gen.stop(timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert results and "ok" in {r.klass for r in results}
    if calls["n"] >= 5:
        assert any(r.status == 429 and r.klass == "shed" for r in results)
    if calls["n"] >= 7:
        assert any(r.status == 503 and r.klass == "error" for r in results)
    streams = [r for r in results if r.stream and r.klass == "ok"]
    assert streams and all(r.ttft_s is not None and r.tokens_out == 3
                           for r in streams)
    assert any(len(r.tbt_s) == 2 for r in streams)
    snap = mx.snapshot()
    assert snap["counters"]["loadgen.requests"] == len(results)


# ----------------------------------------------------- the training tier
V, D, L, NH, FF, RANK, SEQ, SAMPLES = 32, 16, 1, 2, 32, 2, 16, 32


def _jax_schedule(cid, r, n, bs=8, epochs=1):
    rng = jax.random.fold_in(jax.random.key(cid), r)
    return np.asarray(jax_batch_indices(rng, n, bs, epochs))


def _max_rel(got: dict, want: dict, init: dict) -> float:
    upd = max(float(np.abs(want[k][j] - init[k][j]).max())
              for k in want for j in ("a", "b"))
    return max(float(np.abs(np.asarray(got[k][j], np.float64)
                            - want[k][j]).max())
               for k in want for j in ("a", "b")) / upd


def _host(tree):
    return {k: {j: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for j, v in ab.items()} for k, ab in tree.items()}


def test_training_tier_matches_jax():
    """The live loop's federation — SiloSoakHarness over the LoRA
    trainer_factory, the adapter dict federated over a frozen base with
    the nwp objective — 2 silos, 2 rounds, against the JAX loop's, the
    JAX trainers' batch draws handed over."""
    seed, n_clients, rounds = 0, 2, 2
    fm = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=NH, d_ff=FF,
                scan_layers=True)
    base = fm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    ads0 = jax.tree.map(np.asarray, jax_lora_init(
        jax.random.key(seed + 1), base, rank=RANK, a_std=0.1))
    jtargs = JaxTrainArgs(epochs=1, batch_size=8, learning_rate=0.1,
                          client_num_in_total=n_clients,
                          client_num_per_round=n_clients, comm_round=rounds,
                          extra={"task": "nwp"})
    japply = jax_lora_apply_fn(fm.apply, base)

    def jfactory(cid):
        rs = np.random.RandomState(1000 * seed + cid)
        s = rs.randint(1, V, (SAMPLES, SEQ + 1))
        return JaxSiloTrainer(japply, jtargs, s[:, :-1].astype(np.int32),
                              s[:, 1:].astype(np.int32), seed=cid)

    run = f"jx-loop-{uuid.uuid4().hex[:6]}"
    jh = JaxSoakHarness(n_clients=n_clients, rounds=rounds, seed=seed,
                        run_id=run, init_params=ads0,
                        trainer_factory=jfactory, train_args=jtargs,
                        server_kw=dict(round_timeout=30.0, quorum_frac=1.0))
    try:
        jh.start_all()
        assert jh.wait_done(timeout=120)
        want = _host(adapters_from_jax(jh.server.params, device="cpu"))
        jhist = list(jh.server.history)
    finally:
        jh.close()
        jax_release(run)

    model = TransformerLM.from_state(
        ModelDims(V, D, L, NH, FF),
        params_from_flax(jax.tree.map(np.asarray, base), device="cpu"))
    model.requires_grad_(False)
    init = _host(adapters_from_jax(ads0, device="cpu"))
    targs = TrainArgs(epochs=1, batch_size=8, learning_rate=0.1,
                      client_num_in_total=n_clients,
                      client_num_per_round=n_clients, comm_round=rounds,
                      extra={"task": "nwp"})
    h = SiloSoakHarness(
        n_clients=n_clients, rounds=rounds, seed=seed, init_params=init,
        trainer_factory=lora_trainer_factory(
            lora_apply_fn(model), targs, seed=seed, vocab=V, seq_len=SEQ,
            samples_per_client=SAMPLES, device="cpu",
            batch_schedule=lambda c, r: _jax_schedule(c, r, SAMPLES)),
        train_args=targs,
        server_kw=dict(round_timeout=30.0, quorum_frac=1.0), device="cpu")
    try:
        h.start_all()
        assert h.wait_done(timeout=120)
        got = _host(h.server.params)
        hist = list(h.server.history)
    finally:
        h.close()
    assert [(r["round"], r["n_received"]) for r in hist] == \
        [(r["round"], r["n_received"]) for r in jhist]
    assert sorted(got) == sorted(want)
    assert _max_rel(got, want, init) <= TOL
    # the harness refuses init_params without a trainer, as JAX's does
    with pytest.raises(ValueError) as ei:
        SiloSoakHarness(init_params=init, device="cpu")
    with pytest.raises(ValueError) as ej:
        JaxSoakHarness(init_params=ads0)
    assert str(ei.value) == str(ej.value)


# ------------------------------------------------------------- the loop
def _loop(fault_spec, store, ckpt):
    h = LiveLoopHarness(
        rounds=3, n_clients=2, n_replicas=2, seed=0, store_dir=store,
        checkpoint_dir=ckpt, max_len=32, prefill_chunk=4,
        shed_watermark=6.0, fault_spec=fault_spec,
        traffic=TrafficSpec(seed=0, vocab=32, rate_rps=10.0,
                            duration_s=30.0, stream_frac=0.5,
                            prefix_len=6, suffix_len_max=8, out_len_max=10),
        slo={"shed_frac_max": 0.4, "ttft_p99_slo_ms": 5000.0},
        device="cpu")
    try:
        rep = h.run(timeout=120, tail_s=1.0)
        params = _host(h.silo.server.params)
    finally:
        h.close()
    return rep, params


def test_live_loop_chaos_run_serves_and_trains_bitwise_unkilled():
    """One FaultSpec kills the trainer server (after round 1), a trainer
    client (after round 2) and a replica (at its 8th streamed token): no
    request fails (429 sheds excluded), the fleet ends at version 3 on
    every replica, a replica is revived, and the federation's final
    adapters are bitwise an unkilled run's."""
    c0 = mx.snapshot()["counters"]
    with tempfile.TemporaryDirectory() as store, \
            tempfile.TemporaryDirectory() as ckpt:
        rep, params = _loop(FaultSpec(silo_kill={0: 1, 2: 2},
                                      replica_kill={0: 8}), store, ckpt)
    c1 = mx.snapshot()["counters"]
    with tempfile.TemporaryDirectory() as store:
        rep0, params0 = _loop(None, store, None)
    assert rep["requests"] > 5 and rep["non2xx_excl_shed"] == 0, \
        rep["error_codes"]
    assert rep["kills_executed"] == [(0, 1), (2, 2)]
    assert rep["train_done"] and not rep["train_error"]
    assert rep["fleet_version"] == 3 and rep["converged"]
    assert all(v == 3 for v in rep["fleet_versions"].values()), \
        rep["fleet_versions"]
    assert rep["checks"]["lag_bounded"] and rep["loop_ok"], rep["checks"]
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}
    assert delta.get("fed.chaos.silo_kills", 0) == 2
    assert delta.get("fed.chaos.replica_kills", 0) == 1
    assert delta.get("soak.replica_revives", 0) == 1
    assert delta.get("serving.prefix_hits", 0) > 0
    assert rep0["loop_ok"] and rep0["fleet_version"] == 3
    assert sorted(params) == sorted(params0) and all(
        np.array_equal(params[k][j], params0[k][j])
        for k in params for j in ("a", "b"))


def test_from_config_route_and_refusals(tmp_path):
    cfg = Config.from_dict({"common_args": {"extra": {
        "soak": {"rounds": 2, "n_clients": 1, "n_replicas": 1,
                 "rate_rps": 2.0, "zipf_s": 1.5, "lag_rounds_max": 3},
        "chaos": {"silo_kill": {"0": 1}}}}})
    h = LiveLoopHarness.from_config(cfg, store_dir=str(tmp_path / "a"),
                                    device="cpu")
    try:
        assert h.rounds == 2 and h.silo.n_clients == 1
        assert len(h._replicas) == 1
        assert h.fault_spec.silo_kill == {0: 1}
        assert h.traffic.rate_rps == 2.0 and h.traffic.zipf_s == 1.5
        assert h.slo["lag_rounds_max"] == 3
    finally:
        h.close()
    with pytest.raises(ValueError, match="prompt\\+output"):
        LiveLoopHarness(rounds=2, store_dir=str(tmp_path / "b"), max_len=16,
                        traffic=TrafficSpec(seed=0, vocab=32,
                                            suffix_len_max=16,
                                            out_len_max=12), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        LiveLoopHarness(rounds=2, store_dir=str(tmp_path / "c"),
                        traffic=TrafficSpec(seed=0, vocab=64), device="cpu")
    with pytest.raises(ValueError, match=r"replica_kill names unknown "
                                         r"replica\(s\) \[3\]"):
        LiveLoopHarness(rounds=2, store_dir=str(tmp_path / "d"),
                        fault_spec=FaultSpec(replica_kill={3: 4}),
                        device="cpu")
    with pytest.raises(ValueError, match=r"silo_kill names unknown "
                                         r"rank\(s\) \[5\]"):
        LiveLoopHarness(rounds=2, store_dir=str(tmp_path / "e"),
                        fault_spec=FaultSpec(silo_kill={5: 1}),
                        device="cpu")
    if not torch.cuda.is_available():
        # the CUDA default raises without a GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            LiveLoopHarness(rounds=2, store_dir=str(tmp_path / "f"))
