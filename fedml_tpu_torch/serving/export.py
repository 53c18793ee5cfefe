"""Framework-neutral model export (port of `fedml_tpu/serving/export.py`):
the deploy pipeline's interchange format.

(reference: computing/scheduler/model_scheduler/device_model_deployment.py
:720 `convert_model_to_onnx` — the reference converts trained models to
ONNX so serving does not depend on the training framework. Here the
contract is a flat-tensor manifest: named arrays plus a model recipe, in a
numpy archive any consumer can read.)

LAYOUT CONTRACT (format "fedml-tpu-export/1", the JAX package's):

    <export_dir>/
      manifest.json      UTF-8 JSON, two sections:
        "format":  "fedml-tpu-export/1"
        "tensors": {flat_name: {"shape": [ints], "dtype": numpy-name,
                    "cast_from": original-dtype (only when the stored
                    dtype differs: bfloat16 is stored as float32)}}
        "model":   optional recipe {"model": hub name, "num_classes": int,
                   "model_args": {...}, "input_shape": [ints],
                   "compute_dtype": str}, enough for
                   predictor_from_export to rebuild the model
      tensors.npz        numpy zip archive; one entry per manifest tensor,
                         same flat names, row-major (C-order) arrays

Flat names are the "/"-joined path through a nested tree, so a nested
tree round-trips; the port's own parameter dicts are flat already (their
names, such as "Dense_0.kernel", hold no "/") and are written under those
names. `load_export` restores a bfloat16 tensor as a torch.bfloat16
tensor on the CPU (numpy has no bfloat16); every other tensor comes back
as numpy. `predictor_from_export` takes both kinds of export: one of the
port's flat dicts, or a JAX-written flax tree, carried across with
`models.hub.params_from_flax`.
"""
from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

Pytree = Any

FORMAT = "fedml-tpu-export/1"
_MANIFEST = "manifest.json"
_TENSORS = "tensors.npz"
_BF16 = "bfloat16"


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor widened to float32 (the
    caller flags it with `cast_from`)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _src_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _BF16 if leaf.dtype == torch.bfloat16 else str(
            _host(leaf).dtype)
    return str(np.asarray(leaf).dtype)


def _flatten(params: Pytree, prefix: str = "") -> dict:
    out = {}
    if isinstance(params, Mapping):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = params
    return out


def _unflatten(flat: dict) -> Pytree:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def export_model(path: str, params: Pytree,
                 model_name: Optional[str] = None,
                 num_classes: Optional[int] = None,
                 model_args: Optional[dict] = None,
                 input_shape: Optional[tuple] = None,
                 compute_dtype: str = "float32") -> dict:
    """Write the flat-tensor export (layout contract above) of `params`
    (the port's parameter dict, or any nested tree of tensors / arrays).
    Returns the manifest dict. `model_name` etc. are optional: without
    them the export is a pure tensor interchange; with them
    predictor_from_export can rebuild a live predictor."""
    os.makedirs(path, exist_ok=True)
    tensors, table = {}, {}
    for name, leaf in sorted(_flatten(params).items()):
        arr = _host(leaf)
        src = _src_dtype(leaf)
        entry = {"shape": [int(d) for d in arr.shape], "dtype": src}
        # portable = a dtype any stock-numpy reader parses (bool/int/uint/
        # float/complex); bfloat16 & friends are stored widened, flagged
        if src == _BF16 or arr.dtype.kind not in "biufc":
            entry["cast_from"] = src
            arr = arr.astype(np.float32)
            entry["dtype"] = "float32"
        tensors[name] = np.ascontiguousarray(arr)
        table[name] = entry
    manifest = {"format": FORMAT, "tensors": table}
    if model_name is not None:
        if num_classes is None:
            raise ValueError(
                "export_model: model_name without num_classes would write a "
                "manifest whose model recipe disagrees with the exported "
                "head tensors; pass the model's num_classes explicitly")
        manifest["model"] = {
            "model": model_name,
            "num_classes": int(num_classes),
            "model_args": dict(model_args or {}),
            "compute_dtype": compute_dtype,
        }
        if input_shape is not None:
            manifest["model"]["input_shape"] = [int(d) for d in input_shape]
    np.savez(os.path.join(path, _TENSORS), **tensors)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def load_export(path: str) -> tuple[Pytree, dict]:
    """(params, manifest) from an export dir: the port's flat dict for a
    port-written export, the nested tree for a "/"-named one. Validates the
    format tag and every tensor's shape/dtype against the manifest — a
    truncated or hand-edited artifact fails loudly, not at inference
    time."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{path!r} is not a {FORMAT} export "
            f"(format={manifest.get('format')!r})")
    with np.load(os.path.join(path, _TENSORS)) as z:
        names = set(z.files)
        want = set(manifest["tensors"])
        if names != want:
            raise ValueError(
                f"export {path!r} tensor set mismatch: manifest has "
                f"{sorted(want - names)[:4]} missing, archive has "
                f"{sorted(names - want)[:4]} extra")
        flat = {}
        for name, entry in manifest["tensors"].items():
            arr = z[name]
            if list(arr.shape) != entry["shape"] or \
                    str(arr.dtype) != entry["dtype"]:
                raise ValueError(
                    f"tensor {name!r} does not match its manifest entry: "
                    f"archive {arr.shape}/{arr.dtype} vs manifest "
                    f"{entry['shape']}/{entry['dtype']}")
            src = entry.get("cast_from")
            if src == _BF16:
                flat[name] = torch.from_numpy(arr).to(torch.bfloat16)
            elif src:
                try:
                    flat[name] = arr.astype(np.dtype(src))
                except TypeError:
                    flat[name] = arr   # a dtype numpy cannot name: widened
            else:
                flat[name] = arr
    return _unflatten(flat), manifest


def torch_params(params: Pytree, device, dtype=None) -> dict:
    """A parameter tree as the port's parameter dict on `device`: a flax
    tree (nested dicts) through `models.hub.params_from_flax`, a flat dict
    of the port's names leaf by leaf. `dtype` casts floating leaves."""
    from ..models import hub

    if any(isinstance(v, Mapping) for v in params.values()):
        return hub.params_from_flax(params, dtype=dtype or torch.float32,
                                    device=device)
    out = {}
    for k, v in params.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def predictor_from_export(path: str, return_probs: bool = True,
                          device=None):
    """A live `TorchPredictor` on `device` (CUDA unless the caller names
    "cpu") from an export that carries a model recipe — the serving-side
    load-back (reference: device_model_deployment.py model-package
    unpack)."""
    from .._device import resolve_device
    from ..models import hub
    from .predictor import TorchPredictor

    dev = resolve_device(device)
    params, manifest = load_export(path)
    spec = manifest.get("model")
    if not spec:
        raise ValueError(
            f"export {path!r} has no 'model' recipe — it is a pure tensor "
            "interchange; pass model_name/num_classes to export_model to "
            "make it servable")
    params = torch_params(params, dev)
    model = hub.create(spec["model"], int(spec["num_classes"]),
                       spec.get("input_shape") or _input_shape(spec["model"],
                                                               params),
                       device="meta", **dict(spec.get("model_args", {})))
    apply_fn = hub.apply_fn(model, spec.get("compute_dtype", "float32"))
    return TorchPredictor(apply_fn, params, return_probs=return_probs,
                          device=dev)


def _input_shape(model_name: str, params: dict) -> Optional[tuple]:
    """The one-sample input shape a recipe without `input_shape` implies:
    the first dense layer's fan-in for the dense-first models (flax infers
    it at the first call; the port's modules are sized when built)."""
    k = params.get("Dense_0.kernel")
    if model_name in ("lr", "mlp") and k is not None:
        return (int(k.shape[0]),)
    return None
