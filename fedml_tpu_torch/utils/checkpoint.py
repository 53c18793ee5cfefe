"""Checkpoint and resume (port of `fedml_tpu/utils/checkpoint.py`, the
reference's layout written with `torch.save` instead of orbax).

Every piece of cross-round state round-trips:

    server_state   (params, optimizer state, round counter, algorithm
                    extra: a dict of those four)
    client_states  (the stacked per-client state: SCAFFOLD c_i, FedDyn
                    h_i, EF-TopK residuals; absent for stateless
                    algorithms)
    hook_state     (the round plugins' state: FoolsGold's and
                    cross-round's history, the lazy worker's last
                    updates; absent without a FULL-mode hook)
    round_idx      (drives the round-seeded client sampler and batch
                    draws, so a resumed run is bitwise the uninterrupted
                    one)

Layout: <dir>/round_<n>/{server_state,client_states,hook_state}.pt and a
`meta.json` sidecar (round, wall time, which parts are present, the history, a
writer's `extra`) written LAST and atomically: its presence marks the
checkpoint complete. Files load with `weights_only=True` onto the
caller's device. Reading a JAX (orbax) checkpoint is out of scope.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Mapping, Optional

import torch

from ..ops.tree import tree_map

_ROUND_RE = re.compile(r"^round_(\d+)$")
_PARTS = ("server_state", "client_states", "hook_state")


class CheckpointStructureError(ValueError):
    """A checkpoint exists but its tree does not match the caller's
    template (other keys, shapes or dtypes): raised with both leaf lists
    instead of a traceback from deep inside a restore."""


def _round_dir(path: str, round_idx: int) -> str:
    return os.path.join(os.path.abspath(path), f"round_{round_idx}")


def latest_round(path: str) -> Optional[int]:
    """Highest complete checkpoint round under `path`, or None."""
    if not os.path.isdir(path):
        return None
    rounds = [int(m.group(1)) for m in map(_ROUND_RE.match, os.listdir(path))
              if m and os.path.exists(os.path.join(path, m.group(0),
                                                   "meta.json"))]
    return max(rounds) if rounds else None


def _resolve(path: str, round_idx: Optional[int]) -> int:
    r = round_idx if round_idx is not None else latest_round(path)
    if r is None:
        raise FileNotFoundError(f"no checkpoints under {path!r}")
    return r


def read_meta(path: str, round_idx: Optional[int] = None) -> dict:
    """The meta.json sidecar without touching any tensors."""
    with open(os.path.join(_round_dir(path, _resolve(path, round_idx)),
                           "meta.json")) as f:
        return json.load(f)


def save_checkpoint(path: str, round_idx: int, server_state,
                    client_states=None, history: Optional[list] = None,
                    keep: Optional[int] = 3,
                    extra: Optional[dict] = None, hook_state=None) -> str:
    """Write one checkpoint; returns its directory. `server_state` is a
    dict of trees (or tensors, ints, None); `keep` prunes older rounds
    (None keeps everything); `extra` is a JSON-able dict for meta.json."""
    d = _round_dir(path, round_idx)
    # a crash between the tensor files and meta.json leaves a meta-less
    # directory: clear that stale attempt (a complete one is never redone)
    if os.path.isdir(d) and not os.path.exists(os.path.join(d, "meta.json")):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    present = {}
    for name, tree in zip(_PARTS, (server_state, client_states, hook_state)):
        present[name] = tree is not None
        if tree is not None:
            torch.save(tree_map(lambda t: t.detach().cpu() if isinstance(
                t, torch.Tensor) else t, tree), os.path.join(d, name + ".pt"))
    meta = {"round": round_idx, "time": time.time(), "present": present,
            "history": history or []}
    if extra is not None:
        meta["extra"] = extra
    tmp = os.path.join(d, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, "meta.json"))
    if keep is not None:
        _prune(path, keep)
    return d


def restore_raw(path: str, name: str = "server_state",
                round_idx: Optional[int] = None, device="cpu"):
    """Template-free restore of one checkpoint part, as saved (nested
    dicts of tensors on `device`)."""
    f = os.path.join(_round_dir(path, _resolve(path, round_idx)),
                     name + ".pt")
    if not os.path.exists(f):
        raise FileNotFoundError(f"checkpoint part {name!r} absent at {f!r}")
    return torch.load(f, map_location=device, weights_only=True)


def _leaves(tree, prefix="") -> dict:
    """{path: (shape, dtype) or the value} of a tree's leaves."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype))}
    return {prefix: type(tree).__name__}


def _listing(leaves: dict, limit: int = 12) -> list:
    names = sorted(leaves)
    return names[:limit] + (["..."] if len(names) > limit else [])


def check_structure(d: str, name: str, saved, template) -> None:
    got, want = _leaves(saved), _leaves(template)
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise CheckpointStructureError(
            f"checkpoint {name!r} under {d!r} does not match the restore "
            f"template: saved leaves {_listing(got)} vs template leaves "
            f"{_listing(want)}; they differ at {diff[:6]} — was this "
            "checkpoint written by a different runtime or configuration?")


def restore_checkpoint(path: str, server_template,
                       client_template=None,
                       round_idx: Optional[int] = None, device="cpu",
                       hook_template=None):
    """(round_idx, server_state, client_states, hook_state, history) of
    the latest (or `round_idx`) checkpoint, each part held to its
    template's structure (keys, shapes, dtypes) and loaded onto `device`.
    A part that is absent, or has no template, comes back None."""
    r = _resolve(path, round_idx)
    d = _round_dir(path, r)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)

    def load(name, template):
        if not meta["present"].get(name) or template is None:
            return None
        saved = torch.load(os.path.join(d, name + ".pt"),
                           map_location=device, weights_only=True)
        check_structure(d, name, saved, template)
        return saved

    return (r, load("server_state", server_template),
            load("client_states", client_template),
            load("hook_state", hook_template), meta.get("history", []))


def _prune(path: str, keep: int) -> None:
    rounds = sorted(int(m.group(1)) for m in
                    map(_ROUND_RE.match, os.listdir(path)) if m)
    for r in rounds[:-keep] if keep else []:
        shutil.rmtree(_round_dir(path, r), ignore_errors=True)
