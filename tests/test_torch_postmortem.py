"""The port's crash flight recorder (`fedml_tpu_torch/utils/postmortem.py`):
arm, the inflight spill, flush, load, disarm and the frame ring fed by
`comm/base.py`'s encode / decode choke points, held to the JAX package's
document shape."""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest
import torch

from fedml_tpu.utils import postmortem as jpm
from fedml_tpu_torch.comm import FedCommManager, Message
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import metrics as pmx
from fedml_tpu_torch.utils import postmortem as pm

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def flight():
    """A fresh recorder on the port's recorder, disarmed afterwards."""
    fr = pm.FlightRecorder(cap_spans=8, cap_frames=4, spill_every_s=0.05)
    pev.recorder.sinks.append(fr.sink)
    yield fr
    fr.disarm()
    pev.recorder.sinks.remove(fr.sink)


def test_snapshot_shape_matches_jax(flight):
    with pev.recorder.span("train", round=3):
        pass
    flight.note_frame("send", "c2s", 1, 0, 128, {"trace": object()})
    jfr = jpm.FlightRecorder()
    jfr.sink("span", {"name": "train", "round": 3})
    jfr.note_frame("send", "c2s", 1, 0, 128, {"trace": object()})
    got, want = flight.snapshot("manual"), jfr.snapshot("manual")
    assert set(got) == set(want)
    assert got["schema"] == want["schema"] == 1
    assert got["last_span"] == want["last_span"] == "train"
    assert set(got["frames"][0]) == set(want["frames"][0])
    frame = {k: v for k, v in got["frames"][0].items() if k != "t"}
    assert frame["headers"]["trace"].startswith("<object")   # repr'd
    assert {k: v for k, v in frame.items() if k != "headers"} == {
        "dir": "send", "type": "c2s", "sender": 1, "receiver": 0,
        "bytes": 128}
    json.dumps(got)                           # always serializable


def test_arm_spill_flush_load_disarm(flight, tmp_path):
    base = pmx.snapshot()["counters"].get("obs.postmortem.flushes", 0)
    flight.arm(str(tmp_path), process="silo-1", install_handlers=False)
    pmx.inc("t.flight.delta", 3)
    with pev.recorder.span("comm.send.x"):
        pass
    path = tmp_path / pm.POSTMORTEM_FILE
    deadline = time.monotonic() + 5
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    spill = json.loads(path.read_text())
    assert spill["reason"] == "inflight" and spill["process"] == "silo-1"
    assert spill["metric_deltas"]["t.flight.delta"] == 3
    loaded = pm.load_postmortem(str(tmp_path))
    assert loaded["reason"].startswith("hard-kill")
    assert jpm.load_postmortem(str(tmp_path))["reason"] == loaded["reason"]
    assert flight.flush("finish") == str(path)
    time.sleep(0.15)                          # the spill must not overwrite
    assert pm.load_postmortem(str(tmp_path))["reason"] == "finish"
    assert pmx.snapshot()["counters"]["obs.postmortem.flushes"] == base + 1
    flight.disarm()
    assert flight.armed_dir is None and flight.flush("late") is None


def test_record_kill_flushes_when_armed(tmp_path):
    n0 = pmx.snapshot()["counters"].get("obs.postmortem.kills", 0)
    assert pm.record_kill("unarmed") is None
    pm.flight.arm(str(tmp_path), install_handlers=False)
    try:
        path = pm.record_kill("rank 2")
    finally:
        pm.flight.disarm()
    assert json.loads(Path(path).read_text())["reason"] == "kill:rank 2"
    assert pmx.snapshot()["counters"]["obs.postmortem.kills"] == n0 + 2
    assert pm.load_postmortem(str(tmp_path / "none")) is None


def test_frame_ring_over_loopback():
    """Every frame through the transports' encode and decode is noted in
    the process's recorder: type, direction, ranks and bytes."""
    run = f"pm-{uuid.uuid4().hex[:6]}"
    # a type of this test's own: the ring is the process's, and other
    # tests in the same process send "ping" frames of their own
    kind = f"ping-{run}"
    a = FedCommManager(LoopbackTransport(0, run), 0)
    b = FedCommManager(LoopbackTransport(1, run), 1)
    got = threading.Event()
    b.register_message_receive_handler(kind, lambda m: got.set())
    a.run(background=True)
    b.run(background=True)
    try:
        a.send_message(Message(kind, 0, 1).add("x", 1))
        assert got.wait(timeout=10)
    finally:
        a.stop()
        b.stop()
        release_router(run)
    frames = [f for f in pm.flight.snapshot("t")["frames"]
              if f["type"] == kind]
    assert [f["dir"] for f in frames] == ["send", "recv"]
    assert all(f["sender"] == 0 and f["receiver"] == 1 and f["bytes"] > 0
               for f in frames)
    assert frames[0]["bytes"] == frames[1]["bytes"]


_CHILD = """
import os, sys, time
sys.path.insert(0, {root!r})
from fedml_tpu_torch.utils import postmortem as pm
from fedml_tpu_torch.utils.events import recorder
pm.flight.spill_every_s = 0.05
pm.arm({d!r}, process="child")
with recorder.span("train", round=0):
    pass
print("armed", flush=True)
time.sleep(60)
"""


@pytest.mark.parametrize("sig,reason", [
    (signal.SIGKILL, "hard-kill (inflight spill; SIGKILL or crash)"),
    (signal.SIGTERM, "sigterm")])
def test_killed_process_leaves_its_postmortem(tmp_path, sig, reason):
    """A SIGKILLed process leaves its last inflight spill (read as a hard
    kill); a SIGTERMed one flushes with the reason."""
    d = tmp_path / "run"
    p = subprocess.Popen([sys.executable, "-c", _CHILD.format(
        root=str(ROOT), d=str(d))], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        assert p.stdout.readline().strip() == "armed"
        time.sleep(0.3)                       # a few spills
        p.send_signal(sig)
        p.wait(timeout=30)
    finally:
        p.kill()
    doc = pm.load_postmortem(str(d))
    assert doc["reason"] == reason and doc["process"] == "child"
    assert doc["last_span"] == "train"


def test_rearmed_process_still_ends_on_sigterm(tmp_path):
    """A process that arms the recorder more than once (one run dir after
    another) flushes once on SIGTERM and then ends by the signal: the
    handler never chains to itself."""
    d = tmp_path / "run"
    child = _CHILD.replace(
        'pm.arm({d!r}, process="child")',
        'pm.arm({d!r} + "0", process="child")\n'
        'pm.arm({d!r}, process="child")\n'
        'pm.arm({d!r}, process="child")')
    p = subprocess.Popen([sys.executable, "-c", child.format(
        root=str(ROOT), d=str(d))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        assert p.stdout.readline().strip() == "armed"
        p.send_signal(signal.SIGTERM)
        _out, err = p.communicate(timeout=30)
    finally:
        p.kill()
    assert p.returncode == -signal.SIGTERM, err[-2000:]
    assert "RecursionError" not in err
    doc = pm.load_postmortem(str(d))
    assert doc["reason"] == "sigterm" and doc["process"] == "child"
