"""Model hub: (model name, input shape) -> nn.Module (port of
`fedml_tpu/models/hub.py`).

The vision models of the FedAvg path: LogisticRegression, MLP, the
FedAvg-paper CNN and ResNet-v1 with GroupNorm (resnet18 / resnet18_gn,
resnet20, resnet56). The federated round trains their parameters as a
dict of tensors and applies a module through `apply_fn` (one
`torch.func.functional_call`), so the module itself is only structure: it
may live on the "meta" device.

Layout: parameters keep flax's names (`Conv_0.kernel`,
`ResNetBlock_3.GroupNorm_1.scale`, `Dense_0.bias`, ...). Dense kernels
stay flax's `[in, out]` and are applied as `x @ W + b`; conv kernels are
OIHW (`params_from_flax` transposes flax's HWIO). Inputs are the
dataset's NHWC images; a conv model views them as NCHW with
`x.permute(0, 3, 1, 2)` (the strides of `torch.channels_last`, no copy)
and flattens in NHWC order, as flax does. Three details of flax are kept:
"SAME" padding is flax's (an even input at stride 2 pads (0, 1), not
(1, 1)), GroupNorm's eps is 1e-6 with statistics in f32 for a bf16 input
(PyTorch's group_norm kernels accumulate in f32), and every weight is
cast to the compute dtype at use, so the trained parameters stay f32.
"""
from __future__ import annotations

import copy
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..core.registry import MODELS

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_GN_EPS = 1e-6   # flax GroupNorm's epsilon


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax / XLA "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """flax Dense: `kernel` [in, out], `bias` [out]."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.kernel = _param((d_in, d_out), dtype, device)
        self.bias = _param((d_out,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return torch.addmm(self.bias.to(dt), x, self.kernel.to(dt))


class Conv(nn.Module):
    """flax Conv with "SAME" padding: `kernel` OIHW, optional `bias`."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 use_bias: bool, dtype, device):
        super().__init__()
        self.k, self.stride = k, stride
        self.kernel = _param((c_out, c_in, k, k), dtype, device)
        self.bias = _param((c_out,), dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        (h0, h1), (w0, w1) = (_same_pad(x.shape[2], self.k, self.stride),
                              _same_pad(x.shape[3], self.k, self.stride))
        if (h0, w0) != (h1, w1):
            x, pad = F.pad(x, (w0, w1, h0, h1)), 0
        else:
            pad = (h0, w0)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.kernel.to(dt), bias, self.stride, pad)


class GroupNorm(nn.Module):
    """flax GroupNorm over NCHW (groups of consecutive channels)."""

    def __init__(self, groups: int, c: int, dtype, device):
        super().__init__()
        self.groups = groups
        self.scale = _param((c,), dtype, device)
        self.bias = _param((c,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return F.group_norm(x, self.groups, self.scale.to(dt),
                            self.bias.to(dt), _GN_EPS)


def _compute_dtype(model: nn.Module, dtype):
    return dtype or next(model.parameters()).dtype


class LogisticRegression(nn.Module):
    """One dense layer over the flattened input."""

    def __init__(self, num_classes: int, input_shape: Sequence[int], *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        self.Dense_0 = Dense(int(np.prod(input_shape)), num_classes, dtype,
                             dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(_compute_dtype(self, dtype))
        return self.Dense_0(x)


class MLP(nn.Module):
    def __init__(self, num_classes: int, input_shape: Sequence[int],
                 hidden: Sequence[int] = (256, 128), *, dtype=torch.float32,
                 device=None):
        super().__init__()
        dev = _device(device)
        dims = [int(np.prod(input_shape)), *hidden, num_classes]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"Dense_{i}", Dense(a, b, dtype, dev))
        self.n_layers = len(dims) - 1

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(_compute_dtype(self, dtype))
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


class CNN(nn.Module):
    """The FedAvg-paper 2-conv CNN: conv 32 -> pool -> conv 64 -> pool ->
    dense 128 -> dense classes, 3x3 "SAME" convs with bias, 2x2 max pools
    ("VALID")."""

    def __init__(self, num_classes: int, input_shape: Sequence[int], *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        h, w, c = input_shape
        self.Conv_0 = Conv(c, 32, 3, 1, True, dtype, dev)
        self.Conv_1 = Conv(32, 64, 3, 1, True, dtype, dev)
        self.Dense_0 = Dense((h // 2 // 2) * (w // 2 // 2) * 64, 128, dtype,
                             dev)
        self.Dense_1 = Dense(128, num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x)


class ResNetBlock(nn.Module):
    """Two 3x3 convs with GroupNorm; a 1x1 projection (conv + GroupNorm)
    on the residual when the shape changes."""

    def __init__(self, c_in: int, filters: int, stride: int, dtype, device,
                 groups: int = 32):
        super().__init__()
        g = min(groups, filters)
        self.Conv_0 = Conv(c_in, filters, 3, stride, False, dtype, device)
        self.GroupNorm_0 = GroupNorm(g, filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, 3, 1, False, dtype, device)
        self.GroupNorm_1 = GroupNorm(g, filters, dtype, device)
        self.project = c_in != filters or stride != 1
        if self.project:
            self.Conv_2 = Conv(c_in, filters, 1, stride, False, dtype,
                               device)
            self.GroupNorm_2 = GroupNorm(g, filters, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        res = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return torch.relu(y + res)


class ResNet(nn.Module):
    """ResNet-v1 with GroupNorm; `stage_sizes` blocks per stage, filters
    doubling per stage, stride 2 at the first block of every stage after
    the first. The CIFAR stem is one 3x3 conv; the other stem a 7x7
    stride-2 conv and a 3x3 stride-2 "SAME" max pool."""

    def __init__(self, num_classes: int, input_shape=None,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 filters: int = 64, cifar_stem: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        c = input_shape[-1] if input_shape is not None else 3
        self.cifar_stem = cifar_stem
        self.Conv_0 = Conv(c, filters, 3 if cifar_stem else 7,
                           1 if cifar_stem else 2, False, dtype, dev)
        self.GroupNorm_0 = GroupNorm(min(32, filters), filters, dtype, dev)
        blocks, c, n = [], filters, 0
        for i, n_blocks in enumerate(stage_sizes):
            f = filters * (2 ** i)
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"ResNetBlock_{n}",
                        ResNetBlock(c, f, stride, dtype, dev))
                c, n = f, n + 1
        self.n_blocks = n
        self.Dense_0 = Dense(c, num_classes, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(_compute_dtype(self, dtype))
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        if not self.cifar_stem:
            (h0, h1), (w0, w1) = (_same_pad(x.shape[2], 3, 2),
                                  _same_pad(x.shape[3], 3, 2))
            x = F.max_pool2d(F.pad(x, (w0, w1, h0, h1), value=-math.inf),
                             3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def _device(device):
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


# extra model_args keys are ignored, as the JAX hub's factories ignore them
# (reference YAMLs carry keys such as model_file_cache_folder)
MODELS.register("lr")(lambda num_classes, input_shape, dtype, device, **kw:
                      LogisticRegression(num_classes, input_shape,
                                         dtype=dtype, device=device))
MODELS.register("mlp")(lambda num_classes, input_shape, dtype, device, **kw:
                       MLP(num_classes, input_shape, dtype=dtype,
                           device=device))
MODELS.register("cnn")(lambda num_classes, input_shape, dtype, device, **kw:
                       CNN(num_classes, input_shape, dtype=dtype,
                           device=device))
for _name in ("resnet18", "resnet18_gn"):
    MODELS.register(_name)(
        lambda num_classes, input_shape, dtype, device, **kw: ResNet(
            num_classes, input_shape, dtype=dtype, device=device))
MODELS.register("resnet20")(
    lambda num_classes, input_shape, dtype, device, **kw: ResNet(
        num_classes, input_shape, stage_sizes=(3, 3, 3), filters=16,
        dtype=dtype, device=device))
MODELS.register("resnet56")(
    lambda num_classes, input_shape, dtype, device, **kw: ResNet(
        num_classes, input_shape, stage_sizes=(9, 9, 9), filters=16,
        dtype=dtype, device=device))


def create(model_name: str, num_classes: int, input_shape: Sequence[int],
           *, dtype=torch.float32, device=None, **kwargs) -> nn.Module:
    """A registered model for inputs of `input_shape` (one sample, NHWC
    for images), its parameters allocated uninitialised on `device` (CUDA
    unless the caller names "cpu"; "meta" allocates nothing). CharRNN
    waits for the token tasks (ROADMAP 'Port queue' item 3b), the other
    model families are item 5."""
    if model_name.lower() not in MODELS:
        item = "3b" if model_name.lower() == "rnn" else "5"
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet (ROADMAP 'Port queue' "
            f"item {item}; ported: {MODELS.names()})")
    return MODELS.get(model_name)(num_classes, tuple(input_shape),
                                  dtype=dtype, device=device, **kwargs)


def init_params(module: nn.Module, generator: torch.Generator,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random parameters for `module`, drawn on the generator's device from
    `generator`, at flax's initialisers: kernels lecun-normal (normal
    truncated at two standard deviations, std 1/sqrt(fan_in) after
    truncation; fan_in = in for a dense [in, out], in x kh x kw for a conv
    OIHW), biases zero, GroupNorm scales one."""
    dev = generator.device
    out: dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = p.shape[0] if p.dim() == 2 else math.prod(p.shape[1:])
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            w = torch.empty(p.shape, dtype=torch.float32, device=dev)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            out[name] = w.to(dtype)
        elif leaf == "scale":
            out[name] = torch.ones(p.shape, dtype=dtype, device=dev)
        else:
            out[name] = torch.zeros(p.shape, dtype=dtype, device=dev)
    return out


def params_from_flax(params, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """A flax parameter tree of this hub's models (nested dicts of arrays,
    with or without the top-level "params") -> this module's parameter
    dict: names joined with ".", conv kernels HWIO -> OIHW, dense kernels
    kept [in, out]."""
    dev = resolve_device(device)
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
            return
        arr = np.array(node, np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[".".join(prefix)] = torch.from_numpy(
            np.ascontiguousarray(arr)).to(device=dev, dtype=dtype)

    walk((), params)
    return out


def mixed_precision_apply(apply_fn, compute_dtype: str):
    """Wrap a model for mixed-precision compute: a floating input is cast
    to `compute_dtype`, the model runs with `dtype=compute_dtype` (it casts
    its floating weights to that dtype at use, so trained parameters and
    the optimizer stay f32), and the output comes back f32 so the loss is
    taken in f32. float32 returns `apply_fn` itself."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}; got {compute_dtype!r}")
    dtype = COMPUTE_DTYPES[compute_dtype]
    if dtype == torch.float32:
        return apply_fn

    def wrapped(x, *args, **kwargs):
        if x.is_floating_point():
            x = x.to(dtype)
        return apply_fn(x, *args, dtype=dtype, **kwargs).float()

    return wrapped


def structure_copy(module: nn.Module) -> nn.Module:
    """A copy of `module` whose parameters and buffers live on the "meta"
    device (no memory). `functional_call` swaps the given tensors into the
    module for the length of one call, so threads that train concurrently
    (cross-silo clients in one process) each need a module of their own."""
    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else meta)
    return copy.deepcopy(module, memo)


def apply_fn(module: nn.Module, compute_dtype: str = "float32"):
    """(params, x) -> logits: `module` run on the parameter dict `params`
    (names as `module.named_parameters()`) under `mixed_precision_apply`."""
    def run(x, params, dtype=None):
        return torch.func.functional_call(module, params, (x,),
                                          {"dtype": dtype})

    mp = mixed_precision_apply(run, compute_dtype)
    return lambda params, x: mp(x, params)
