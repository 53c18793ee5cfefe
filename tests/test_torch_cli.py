"""The port's CLI, `python -m fedml_tpu_torch` (`fedml_tpu_torch/__main__.py`
and the diagnosis battery `diagnosis.py`), against the JAX package's
`python -m fedml_tpu` on the same inputs: `run`'s last row, `build`'s
manifest, `logs`, `report --format json` and `top --once` on the same run
dir, the verbs that wait for later slices, and the entry points' CUDA
default."""
import json
import os
import re
import subprocess
import sys
import tarfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.__main__ import main as jax_main
from fedml_tpu_torch import mlops
from fedml_tpu_torch.__main__ import main
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import metrics as pmx
from fedml_tpu_torch.utils import postmortem  # noqa: F401 (its always-on sink)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

SMALL = {
    "data_args": {"dataset": "synthetic",
                  "extra": {"synthetic_samples_per_client": 16}},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 2,
                   "client_num_per_round": 2, "comm_round": 3, "epochs": 1,
                   "batch_size": 8, "learning_rate": 0.3},
    "validation_args": {"frequency_of_the_test": 1},
    "comm_args": {"backend": "sp"},
}


def _out(capsys, fn, argv):
    rc = fn(argv)
    return rc, capsys.readouterr()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tracked run of the port's: init -> mlops.init -> the Simulator's
    run (G = 1, 2 rounds, an eval on each) -> mlops.finish."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    d = tmp_path_factory.mktemp("run")
    sinks = list(pev.recorder.sinks)
    cfg = fedml_tpu_torch.init(config={
        **SMALL, "train_args": {**SMALL["train_args"], "comm_round": 2},
        "tracking_args": {"enable_tracking": True, "log_file_dir": str(d),
                          "run_name": "clirun",
                          "extra": {"sysperf_interval": 0.05}}},
        device="cpu")
    mlops.init(cfg)
    try:
        Simulator(cfg).run()
        pmx.inc("t.cli.report")
        time.sleep(0.1)
    finally:
        mlops.finish()
        pev.recorder.sinks[:] = sinks
    return d


def test_version_and_env(capsys):
    rc, out = _out(capsys, main, ["version"])
    assert rc == 0 and out.out.strip() == \
        f"fedml_tpu_torch {fedml_tpu_torch.__version__}"
    rc, out = _out(capsys, main, ["env"])
    info = json.loads(out.out)
    assert rc == 0 and info["torch"] == torch.__version__
    assert {"cuda", "cuda_available", "device_count", "devices", "nvcc",
            "triton", "numpy"} <= set(info)
    if not torch.cuda.is_available():
        assert info["device_count"] == 0 and info["devices"] == []


def test_run_device_cpu_prints_the_jax_row_keys(tmp_path, capsys):
    """`run --cf --device cpu` as a subprocess on a small JSON config: the
    last line is the last round's row with the keys the JAX CLI prints."""
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(SMALL))
    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch", "run", "--cf", str(p),
         "--rounds", "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    rc, jout = _out(capsys, jax_main, ["run", "--cf", str(p), "--rounds",
                                       "2"])
    want = json.loads(jout.out.strip().splitlines()[-1])
    assert rc == 0 and row["round"] == want["round"] == 1
    assert set(row) == set(want)


def test_run_refuses_the_message_layer_roles_as_jax(tmp_path, capsys):
    p = tmp_path / "cs.json"
    p.write_text(json.dumps({"common_args": {"training_type": "cross_silo"}}))
    rc, out = _out(capsys, main, ["run", "--cf", str(p), "--device", "cpu"])
    jrc, _ = _out(capsys, jax_main, ["run", "--cf", str(p)])
    assert rc == jrc == 2 and "python API" in out.err


def test_build_manifest_equals_jax(tmp_path, capsys):
    src = tmp_path / "job"
    (src / "pkg").mkdir(parents=True)
    rng = np.random.default_rng(0)
    (src / "main.py").write_text("print('hi')\n")
    (src / "pkg" / "data.bin").write_bytes(rng.bytes(4096))
    (src / "fedml_manifest.json").write_text("{}")     # superseded
    manifests = []
    for tag, fn in (("port", main), ("jax", jax_main)):
        rc, out = _out(capsys, fn, ["build", "--source", str(src),
                                    "--entry", "main.py", "--dest",
                                    str(tmp_path / tag)])
        assert rc == 0
        info = json.loads(out.out)
        with tarfile.open(info["package"]) as tar:
            names = tar.getnames()
            man = json.load(tar.extractfile("job/fedml_manifest.json"))
        assert names.count("job/fedml_manifest.json") == 1
        man.pop("created")
        manifests.append((info["files"], man))
    assert manifests[0] == manifests[1]
    assert manifests[0][1]["files"]["pkg/data.bin"] == \
        __import__("hashlib").sha256(
            (src / "pkg" / "data.bin").read_bytes()).hexdigest()
    rc, out = _out(capsys, main, ["build", "--source", str(src), "--entry",
                                  "nope.py", "--dest", str(tmp_path)])
    assert rc == 1 and "not found" in out.err


def test_logs_as_jax(run_dir, capsys):
    for argv in (["logs", "--log-dir", str(run_dir), "--list"],
                 ["logs", "--log-dir", str(run_dir), "--run", "clirun",
                  "--tail", "2"],
                 ["logs", "--log-dir", str(run_dir / "missing")]):
        rc, out = _out(capsys, main, argv)
        jrc, jout = _out(capsys, jax_main, argv)
        assert (rc, out.out, out.err) == (jrc, jout.out, jout.err), argv
    runs = json.loads(_out(capsys, main, ["logs", "--log-dir", str(run_dir),
                                          "--list"])[1].out)["runs"]
    assert {"clirun.events.jsonl", "clirun.log", "clirun.trace.json",
            "postmortem.json"} <= set(runs)


def test_report_json_equals_jax(run_dir, capsys):
    argv = ["report", "--log-dir", str(run_dir), "--format", "json"]
    rc, out = _out(capsys, main, argv)
    jrc, jout = _out(capsys, jax_main, argv)
    assert rc == jrc == 0
    got, want = json.loads(out.out), json.loads(jout.out)
    assert got == want
    assert got["schema"] == 2 and got["spans"]["train"]["count"] == 2
    assert [r["round"] for r in got["budget"]["rounds"]] == [0, 1]
    assert got["postmortem"]["reason"] == "finish"
    assert got["sysperf_rows"] >= 1 and got["trace_path"]
    # the text report: the same exit code and the same lines
    rc, out = _out(capsys, main, argv[:-2])
    jrc, jout = _out(capsys, jax_main, argv[:-2])
    assert rc == jrc == 0 and out.out == jout.out
    assert "spans:" in out.out and "clirun.trace.json" in out.out


def test_report_without_rows_fails_as_jax(tmp_path, capsys):
    (tmp_path / "empty.events.jsonl").write_text("not json\n")
    for argv in (["report", "--log-dir", str(tmp_path)],
                 ["report", "--log-dir", str(tmp_path / "none")]):
        rc, out = _out(capsys, main, argv)
        jrc, jout = _out(capsys, jax_main, argv)
        assert rc == jrc == 1 and out.err == jout.err


def _frame(text: str) -> str:
    return re.sub(r"\(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\)", "(T)", text)


def test_top_once_same_frame_as_jax(run_dir, capsys):
    argv = ["top", "--once", "--log-dir", str(run_dir)]
    rc, out = _out(capsys, main, argv)
    jrc, jout = _out(capsys, jax_main, argv)
    assert rc == jrc == 0 and _frame(out.out) == _frame(jout.out)
    assert "rounds_total" in out.out and "budget: wall" in out.out


def test_top_live_url_frames(capsys):
    """Against a live /metrics endpoint: --frames N renders N frames, the
    later ones with rates."""
    from fedml_tpu_torch.utils.prometheus import MetricsExporter

    pmx.inc("serving.requests")
    pmx.inc("serving.tokens", 10)
    exp = MetricsExporter(port=0).start()
    try:
        rc, out = _out(capsys, main, ["top", "--port", str(exp.port),
                                      "--frames", "2", "--interval", "0.05"])
    finally:
        exp.stop()
    assert rc == 0 and out.out.count("fedml_tpu top") == 2
    assert "tok/s" in out.out


def test_diagnosis_host_probes_on_the_cpu(capsys):
    host = ["wire_codec", "loopback_transport", "chaos_smoke", "codec_smoke",
            "attribution_smoke", "serving_engine_smoke",
            "serving_paged_smoke", "native_lib", "kernels", "cuda"]
    rc, out = _out(capsys, main, ["diagnosis", "--device", "cpu", "--only",
                                  *host])
    rep = json.loads(out.out)
    assert rc == 0 and rep["ok"] is True and rep["device"] == "cpu"
    assert all(rep["checks"][k]["ok"] for k in host
               if k not in ("kernels", "cuda"))
    # the kernels run only on the card: reported as not run, never passed
    assert set(rep["not_run"]) == {"kernels", "cuda"}
    assert "kernels" not in rep["checks"]
    assert rep["checks"]["serving_paged_smoke"]["k4_launches"] == 0
    assert all(v["seconds"] >= 0 for v in rep["checks"].values())
    rc, out = _out(capsys, main, ["diagnosis", "--device", "cpu", "--only",
                                  "nope"])
    assert rc == 2 and "unknown probe" in out.err


@pytest.mark.parametrize("argv,entry", [
    (["bench"], "benchmark of the port"),
    (["lint"], "entry 8"),
    (["report", "--merge", "a", "b"], "entry 8"),
    (["report", "--fleet", "http://x"], "entry 8"),
    (["top", "--fleet", "--port", "1"], "entry 8")])
def test_later_verbs_exit_2(capsys, argv, entry):
    rc, out = _out(capsys, main, argv)
    assert rc == 2 and "not ported yet" in out.err and entry in out.err


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without --device, `run` and `diagnosis` ask for CUDA and raise where
    no GPU is visible; nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(SMALL))
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["run", "--cf", str(p)])
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["diagnosis", "--only", "wire_codec"])
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["run", "--cf", str(p), "--device", "cuda"])
