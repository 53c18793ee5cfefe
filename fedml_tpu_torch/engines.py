"""ML-engine adapters: torch and tf.keras trainers behind the silo trainer
contract (port of `fedml_tpu/engines.py`; reference:
core/alg_frame/client_trainer.py, ml/engine/ml_engine_adapter.py).

A silo can train a torch nn.Module or a tf.keras model while the server,
the comm layer and every other silo stay unchanged. The bridge is the
trainer contract of `cross_silo/trainer.py`:

    train(params, round_idx) -> (params, n_samples, metrics)

Parameters cross the boundary as a {name: ndarray} dict (the module's
state_dict names; for keras, "v{i:03d}.{normalized variable path}"). The
server only averages such dicts, so torch silos federate with torch
silos (the same state_dict structure) through `FedServerManager` /
`SecAggServerManager`, as the native C++ trainers do with flat vectors.
`TorchSiloTrainer` runs on the resolved device (CUDA unless the caller
names "cpu"); its batch order comes from a CPU `torch.Generator`, so on
the CPU its parameters are bitwise the JAX package's trainer's.
`tensorflow` is imported only inside `TFSiloTrainer`'s methods.
"""
from __future__ import annotations

import hashlib
import re
from typing import Any, Optional

import numpy as np

from ._device import resolve_device

Pytree = Any


def _normalize_var_path(name: str) -> str:
    """Stable structural name for ONE framework variable: drop the ':0'
    tensor suffix and any trailing `_<digits>` per path segment
    ('sequential_1/dense_2/kernel' -> 'sequential/dense/kernel'). Use
    `_normalize_var_paths` when the full variable list is available — it is
    sibling-aware (see its docstring); this single-name form cannot tell a
    keras process-global uniquifier from a deliberately numbered sibling
    layer, so both strip."""
    name = name.split(":")[0]
    return "/".join(re.sub(r"_\d+$", "", s) for s in name.split("/"))


def _normalize_var_paths(names: list[str]) -> list[str]:
    """Stable structural names for a model's FULL ordered variable list.

    Keras uniquifies layer names process-globally ('dense_2/kernel' in a
    process that built models before), so raw names cannot ride the wire —
    two silos with the same architecture would disagree. Stripping every
    trailing `_<digits>` (the old behavior) fixes that but collapses
    DELIBERATELY numbered sibling layers ('dense' and 'dense_1' in one
    Sequential) onto one name, making different positions fingerprint
    identically.

    Sibling-aware scheme: per path segment, strip the `_<digits>` suffix to
    a base name, then CANONICALLY renumber siblings that share a base under
    the same parent by first-appearance order (first -> 'dense', second ->
    'dense_1', ...). Variable order follows model structure, so two silos
    that built any number of prior models still agree ('dense_7/dense_8'
    and 'dense/dense_1' both normalize to 'dense'/'dense_1'), while true
    siblings keep distinct names — the un-suffixed name is only claimed by
    a sibling when it genuinely is one.

    Remaining trade-off (accepted): a user-chosen name with a trailing
    `_<digits>` and NO same-base sibling ('branch_2' alone) is
    indistinguishable from a uniquifier and loses its suffix; siblings the
    user numbered sparsely ('block_1'/'block_3') renumber densely
    ('block'/'block_1'). Both are deterministic and consistent across
    silos, so federation and fingerprinting stay correct."""
    segs = [n.split(":")[0].split("/") for n in names]
    # (segment position, raw parent path, base) -> {raw segment: ordinal}
    ordinals: dict[tuple, dict[str, int]] = {}
    out = []
    for s in segs:
        norm: list[str] = []
        for i, seg in enumerate(s):
            base = re.sub(r"_\d+$", "", seg)
            slot = ordinals.setdefault((i, tuple(s[:i]), base), {})
            k = slot.setdefault(seg, len(slot))
            norm.append(base if k == 0 else f"{base}_{k}")
        out.append("/".join(norm))
    return out


def arch_fingerprint(entries) -> tuple[str, str]:
    """(fingerprint, description) of an ordered variable structure.

    entries: [(structural_name, shape_tuple, dtype_str), ...] in variable
    order. The fingerprint is a 16-hex sha256 over the full ordered
    structure — layer names, shapes, AND dtypes — so two architectures
    with coincidentally matching variable counts/shapes still differ
    (index-only wire keys made that collision silent). The description
    names the architecture in error messages."""
    entries = list(entries)
    canon = ";".join(
        f"{n}:{'x'.join(str(int(d)) for d in s)}:{t}" for n, s, t in entries)
    fp = hashlib.sha256(canon.encode()).hexdigest()[:16]
    head = ", ".join(f"{n}{tuple(int(d) for d in s)}"
                     for n, s, _t in entries[:4])
    more = ", ..." if len(entries) > 4 else ""
    return fp, f"{len(entries)} vars [{head}{more}]"


class TorchSiloTrainer:
    """Silo trainer over a torch nn.Module, the reference ClientTrainer
    shape (reference: ml/trainer/my_model_trainer_classification.py:29-76:
    per-epoch minibatch SGD and state_dict get / set). `device` is CUDA
    unless the caller names "cpu" (the JAX package's trainer defaults to
    the CPU).

    The module's state_dict is the wire format: get_params/set_params map
    {key: ndarray} <-> module state, so any torch architecture federates
    without registration."""

    def __init__(self, model, x: np.ndarray, y: np.ndarray,
                 lr: float = 0.1, batch_size: int = 32, epochs: int = 1,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 seed: int = 0, device=None):
        import torch

        device = resolve_device(device)
        self.model = model.to(device)
        self.device = device
        self.x = torch.tensor(np.asarray(x, np.float32), device=device)
        self.y = torch.tensor(np.asarray(y, np.int64), device=device)
        self.lr, self.bs, self.epochs = lr, batch_size, epochs
        self.momentum, self.weight_decay = momentum, weight_decay
        self.seed = seed
        self.n_samples = int(self.x.shape[0])
        self.arch_fp, self.arch_desc = arch_fingerprint(
            (k, tuple(v.shape), str(v.dtype))
            for k, v in self.model.state_dict().items())

    # ---- params <-> pytree (numpy dict keyed by state_dict names)
    def get_params(self) -> dict:
        return {k: v.detach().cpu().numpy().copy()
                for k, v in self.model.state_dict().items()}

    def set_params(self, params: dict) -> None:
        import torch

        own = self.model.state_dict()
        if set(params) != set(own):
            in_fp, in_desc = arch_fingerprint(
                (k, np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in sorted(params.items()))
            raise ValueError(
                "architecture mismatch: this silo's model is "
                f"{self.arch_desc} (fp {self.arch_fp}) but the incoming "
                f"params describe {in_desc} (fp {in_fp}); refusing to "
                "federate different architectures")
        for k, v in params.items():
            if np.asarray(v).shape != tuple(own[k].shape):
                raise ValueError(
                    f"shape mismatch for {k}: got {np.asarray(v).shape}, "
                    f"model has {tuple(own[k].shape)}")
        sd = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
        self.model.load_state_dict(sd)

    def train(self, params: Optional[dict], round_idx: int):
        import torch
        import torch.nn.functional as F

        if params is not None:
            self.set_params(params)
        opt = torch.optim.SGD(self.model.parameters(), lr=self.lr,
                              momentum=self.momentum,
                              weight_decay=self.weight_decay)
        g = torch.Generator().manual_seed(self.seed * 100003 + round_idx)
        n = self.n_samples
        bs = min(self.bs, n)
        losses = []
        self.model.train()
        for _ in range(self.epochs):
            order = torch.randperm(n, generator=g)
            for b in range(0, n - bs + 1, bs):
                idx = order[b:b + bs]
                opt.zero_grad()
                loss = F.cross_entropy(self.model(self.x[idx]), self.y[idx])
                loss.backward()
                opt.step()
                losses.append(loss.item())
        metrics = {"train_loss": float(np.mean(losses)) if losses else 0.0}
        return self.get_params(), self.n_samples, metrics

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> dict:
        import torch

        self.model.eval()
        with torch.no_grad():
            xt = torch.tensor(np.asarray(x, np.float32), device=self.device)
            pred = self.model(xt).argmax(dim=1).cpu().numpy()
        return {"test_acc": float((pred == np.asarray(y)).mean())}


class TFSiloTrainer:
    """Silo trainer over a TensorFlow/Keras model — the third engine of the
    reference's adapter family (reference: ml/engine/ml_engine_adapter.py
    :198 dispatches torch/tf/mxnet/jax; tf's model_params_to_device). Same
    contract as TorchSiloTrainer: the wire format is a {name: ndarray}
    pytree keyed by variable path in variable order, so TF silos federate
    through FedServerManager / SecAgg / the scheduler with zero server
    changes.

    The loop is a plain tf.GradientTape SGD over numpy shards — no Keras
    fit() machinery, mirroring the reference trainer's explicit minibatch
    loop. mxnet stays by-design (not installed in any supported image);
    its adapter would be this class with autograd.record() inside."""

    def __init__(self, model, x: np.ndarray, y: np.ndarray,
                 lr: float = 0.1, batch_size: int = 32, epochs: int = 1,
                 seed: int = 0):
        self.model = model
        self.x = np.asarray(x, np.float32)
        self.y = np.asarray(y, np.int64)
        self.lr, self.bs, self.epochs = lr, batch_size, epochs
        self.seed = seed
        self.n_samples = int(self.x.shape[0])
        # build variables eagerly so get/set_params see the full set
        self.model(self.x[:1])
        self._names = _normalize_var_paths([
            str(getattr(v, "path", None) or v.name)
            for v in self.model.variables])
        self.arch_fp, self.arch_desc = arch_fingerprint(
            (n, tuple(v.shape), str(getattr(v.dtype, "name", v.dtype)))
            for n, v in zip(self._names, self.model.variables))

    def _vars(self):
        return self.model.trainable_variables

    # The wire format covers ALL variables (trainable + moving statistics
    # like BatchNorm means, matching TorchSiloTrainer's full state_dict),
    # keyed by zero-padded variable index PLUS the normalized structural
    # name ("v003.sequential/dense/kernel"). Three rules behind that:
    # - an aggregator may rebuild dicts in SORTED key order (the JAX
    #   package's flattens lexicographically), so set_params must look
    #   values up BY KEY — a positional zip mis-assigns weights at >=10
    #   variables
    #   ("v10" sorts before "v2"; zero-padding keeps sorted == creation
    #   order);
    # - the raw v.name/path must NOT ride the key verbatim: keras
    #   uniquifies names process-globally ("dense_2/kernel"), so two silos
    #   that built a different number of models would disagree —
    #   _normalize_var_path strips the uniquifiers so same-architecture
    #   silos agree;
    # - the normalized name MUST ride the key: with index-only keys, two
    #   DIFFERENT architectures with coincidentally matching variable
    #   counts/shapes would federate garbage silently. The name makes the
    #   wire format self-describing, and set_params rejects a structural
    #   mismatch loudly.
    def _key(self, i: int) -> str:
        return f"v{i:03d}.{self._names[i]}"

    def get_params(self) -> dict:
        return {self._key(i): v.numpy().copy()
                for i, v in enumerate(self.model.variables)}

    def set_params(self, params: dict) -> None:
        import logging

        vs = self.model.variables
        if len(params) != len(vs):
            raise ValueError(
                f"param pytree has {len(params)} leaves, model has "
                f"{len(vs)} variables")
        keys = set(params)
        legacy = {f"v{i:03d}" for i in range(len(vs))}
        if keys == legacy:
            # pre-r5 wire format: index-only keys. Shapes are still
            # checked below, but the structural-name check is impossible —
            # accept (old checkpoints/artifacts stay loadable) and say so.
            logging.getLogger(__name__).warning(
                "set_params: params use the pre-r5 index-only TF wire keys "
                "(v000...); structural-name verification skipped — "
                "re-export from a current silo to get name-bearing keys")
            key_of = {i: f"v{i:03d}" for i in range(len(vs))}
        elif keys != {self._key(i) for i in range(len(vs))}:
            in_fp, in_desc = arch_fingerprint(
                (k.split(".", 1)[-1], np.asarray(v).shape,
                 str(np.asarray(v).dtype))
                for k, v in sorted(params.items()))
            raise ValueError(
                "architecture mismatch: this silo's model is "
                f"{self.arch_desc} (fp {self.arch_fp}) but the incoming "
                f"params describe {in_desc} (fp {in_fp}); refusing to "
                "federate different architectures")
        else:
            key_of = {i: self._key(i) for i in range(len(vs))}
        for i, v in enumerate(vs):
            val = np.asarray(params[key_of[i]])
            if val.shape != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch for {key_of[i]}: got "
                    f"{val.shape}, variable is {tuple(v.shape)}")
            v.assign(val)

    def train(self, params: Optional[dict], round_idx: int):
        import tensorflow as tf

        if params is not None:
            self.set_params(params)
        rng = np.random.RandomState(self.seed * 100003 + round_idx)
        n, bs = self.n_samples, min(self.bs, self.n_samples)
        losses = []
        loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
            from_logits=True)
        for _ in range(self.epochs):
            order = rng.permutation(n)
            for b in range(0, n - bs + 1, bs):
                idx = order[b:b + bs]
                xb = tf.constant(self.x[idx])
                yb = tf.constant(self.y[idx])
                with tf.GradientTape() as tape:
                    loss = loss_fn(yb, self.model(xb, training=True))
                grads = tape.gradient(loss, self._vars())
                for v, g in zip(self._vars(), grads):
                    if g is not None:
                        v.assign_sub(self.lr * g)
                losses.append(float(loss))
        metrics = {"train_loss": float(np.mean(losses)) if losses else 0.0}
        return self.get_params(), self.n_samples, metrics

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> dict:
        logits = self.model(np.asarray(x, np.float32), training=False)
        pred = np.asarray(logits).argmax(axis=1)
        return {"test_acc": float((pred == np.asarray(y)).mean())}
