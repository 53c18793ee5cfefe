"""Model hub: (model name, input shape) -> nn.Module (port of
`fedml_tpu/models/hub.py`).

The models of the simulator: LogisticRegression, MLP, the FedAvg-paper
CNN, ResNet-v1 with GroupNorm (resnet18 / resnet18_gn, resnet20,
resnet56), CharRNN (rnn) and, through the LLM package, `transformer_lm`;
the CV families of `models/cv.py` (mobilenet, mobilenet_v3, efficientnet,
vgg11, vgg16), UNetLite (unet, `models/seg.py`) and the DARTS supernet
(darts, `models/darts.py`). The GAN pair waits for FedGAN (ROADMAP
'Port queue' entry 4). The federated round trains a model's parameters
as a dict of tensors and applies the module through `apply_fn` (one
`torch.func.functional_call`), so the module itself is only structure:
it may live on the "meta" device.

Layout: parameters keep flax's names (`Conv_0.kernel`,
`ResNetBlock_3.GroupNorm_1.scale`, `OptimizedLSTMCell_0.hi.kernel`,
`Dense_0.bias`, ...). Dense kernels stay flax's `[in, out]` and are
applied as `x @ W + b`; conv kernels are OIHW (`params_from_flax`
transposes flax's HWIO; a depthwise `[kh, kw, 1, C]` becomes
`[C, 1, kh, kw]`). Inputs are the dataset's NHWC images or int token
ids; a conv model views images as NCHW with `x.permute(0, 3, 1, 2)` (the
strides of `torch.channels_last`, no copy) and flattens in NHWC order,
as flax does. Three details of flax are kept: "SAME" padding is flax's
(an even input at stride 2 pads (0, 1), not (1, 1)), GroupNorm's eps is
1e-6 with statistics in f32 for a bf16 input (PyTorch's group_norm
kernels accumulate in f32), and every weight is cast to the compute
dtype at use, so the trained parameters stay f32.
"""
from __future__ import annotations

import copy
import math
import re
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
    """flax Dense: `kernel` [in, out], optional `bias` [out]. `recurrent`
    marks an LSTM's hidden-to-hidden kernel, which `init_params` draws
    orthogonal (flax's `recurrent_kernel_init`)."""

    def __init__(self, d_in: int, d_out: int, dtype, device,
                 use_bias: bool = True, recurrent: bool = False):
        super().__init__()
        self.recurrent = recurrent
        self.kernel = _param((d_in, d_out), dtype, device)
        self.bias = _param((d_out,), dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.bias is None:
            return x @ self.kernel.to(dt)
        return torch.addmm(self.bias.to(dt), x, self.kernel.to(dt))


class Conv(nn.Module):
    """flax Conv with "SAME" padding: `kernel` OIHW (`[c_out, c_in /
    groups, k, k]`; flax's `feature_group_count`), optional `bias`."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 use_bias: bool, dtype, device, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.kernel = _param((c_out, c_in // groups, k, k), dtype, device)
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
        return F.conv2d(x, self.kernel.to(dt), bias, self.stride, pad,
                        groups=self.groups)


class Embed(nn.Module):
    """flax Embed: `embedding` [vocab, features]."""

    def __init__(self, vocab: int, features: int, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, features), dtype, device)

    def forward(self, tokens: torch.Tensor, dt) -> torch.Tensor:
        return F.embedding(tokens, self.embedding.to(dt))


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


_LSTM_GATES = "ifgo"


class OptimizedLSTMCell(nn.Module):
    """One LSTM layer, the cell as flax's `OptimizedLSTMCell` computes it:
    gates i, f, g, o from `x @ [ii|if|ig|io]` (no bias) plus
    `h @ [hi|hf|hg|ho] + b`, i, f, o sigmoid and g tanh; c' = f c + i g,
    h' = o tanh(c'); the carry starts at zero. Run over [B, T, I] inputs
    as plain tensor ops (so `torch.func.vmap` batches it): the input
    product of every step at once, then one recurrent product a step.
    The carry is f32 (flax's carry dtype), and each product runs in the
    wider dtype of its two operands, as flax promotes: under bf16 compute
    the first layer's input product is bf16 and the rest f32 math on
    bf16-rounded weights."""

    def __init__(self, d_in: int, hidden: int, dtype, device):
        super().__init__()
        self.hidden = hidden
        for g in _LSTM_GATES:
            setattr(self, "i" + g, Dense(d_in, hidden, dtype, device,
                                         use_bias=False))
            setattr(self, "h" + g, Dense(hidden, hidden, dtype, device,
                                         recurrent=True))

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        wi = torch.cat([getattr(self, "i" + g).kernel for g in _LSTM_GATES],
                       -1).to(dt)
        wh = torch.cat([getattr(self, "h" + g).kernel for g in _LSTM_GATES],
                       -1).to(dt)
        bh = torch.cat([getattr(self, "h" + g).bias for g in _LSTM_GATES],
                       -1).to(dt)
        pt = torch.promote_types(x.dtype, dt)
        xw = x.to(pt) @ wi.to(pt)                            # [B, T, 4H]
        f32 = torch.float32
        wh, bh = wh.to(f32), bh.to(f32)
        c = torch.zeros(x.shape[0], self.hidden, dtype=f32, device=x.device)
        h = c
        out = []
        for t in range(x.shape[1]):
            z = torch.addmm(bh, h, wh) + xw[:, t]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class CharRNN(nn.Module):
    """The next-token LSTM LM of the shakespeare tasks: `Embed(vocab,
    embed_dim)`, two `OptimizedLSTMCell` layers of `hidden`, then
    `Dense(vocab)`. int tokens [B, T] -> logits [B, T, vocab]."""

    def __init__(self, vocab_size: int, input_shape=None, embed_dim: int = 8,
                 hidden: int = 256, *, dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        self.Embed_0 = Embed(vocab_size, embed_dim, dtype, dev)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embed_dim, hidden, dtype,
                                                     dev)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden, hidden, dtype,
                                                     dev)
        self.Dense_0 = Dense(hidden, vocab_size, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = _compute_dtype(self, dtype)
        h = self.Embed_0(x, dt)
        h = self.OptimizedLSTMCell_0(h, dt)
        h = self.OptimizedLSTMCell_1(h, dt)              # f32 [B, T, H]
        head = self.Dense_0
        return h @ head.kernel.to(dt).to(h.dtype) + head.bias.to(dt).to(
            h.dtype)


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


# the families below take their own knobs from model_args.extra, as the
# JAX factories pass them on (an unknown key is a TypeError there too)
MODELS.register("rnn")(
    lambda num_classes, input_shape, dtype, device, **kw: CharRNN(
        num_classes, input_shape, dtype=dtype, device=device, **kw))


def _transformer_lm(num_classes, input_shape, dtype, device, d_model=128,
                    n_layers=2, n_heads=4, d_ff=256):
    """The FedLLM base model (`llm/transformer.py`, dense attention), its
    vocabulary the dataset's classes and its size from model_args.extra
    (the JAX TransformerLM's defaults)."""
    from ..llm.transformer import ModelDims, TransformerLM

    return TransformerLM(ModelDims(num_classes, d_model, n_layers, n_heads,
                                   d_ff), dtype=dtype, device=device)


MODELS.register("transformer_lm")(_transformer_lm)


def _cv(name):
    def build(num_classes, input_shape, dtype, device, **kw):
        from . import cv

        cls, fixed = {"mobilenet": (cv.MobileNetV1, {}),
                      "mobilenet_v3": (cv.MobileNetV3Small, {}),
                      "efficientnet": (cv.EfficientNetLite, {}),
                      "vgg11": (cv.VGG, {}),
                      "vgg16": (cv.VGG, {"stages": cv.VGG16_STAGES})}[name]
        return cls(num_classes, input_shape, dtype=dtype, device=device,
                   **fixed, **kw)

    return build


for _name in ("mobilenet", "mobilenet_v3", "efficientnet", "vgg11", "vgg16"):
    MODELS.register(_name)(_cv(_name))


def _darts(num_classes, input_shape, dtype, device, **kw):
    from .darts import DartsNet

    return DartsNet(num_classes, input_shape, dtype=dtype, device=device,
                    **kw)


# FedAvg over this model's parameters (weights and the `alpha` leaves)
# is FedNAS
MODELS.register("darts")(_darts)


def _unet(num_classes, input_shape, dtype, device, **kw):
    from .seg import UNetLite

    return UNetLite(num_classes, input_shape, dtype=dtype, device=device,
                    **kw)


# pairs with the "segmentation" objective (core/algorithm.py)
MODELS.register("unet")(_unet)


def create(model_name: str, num_classes: int, input_shape: Sequence[int],
           *, dtype=torch.float32, device=None, **kwargs) -> nn.Module:
    """A registered model for inputs of `input_shape` (one sample: NHWC
    for images, [T] for token ids), its parameters allocated
    uninitialised on `device` (CUDA unless the caller names "cpu"; "meta"
    allocates nothing). `gan` waits for FedGAN (ROADMAP 'Port queue'
    entry 4)."""
    if model_name.lower() == "gan":
        raise NotImplementedError(
            "model 'gan' is not ported yet (ROADMAP 'Port queue' entry 4, "
            "with algorithms/fedgan.py)")
    return MODELS.get(model_name)(num_classes, tuple(input_shape),
                                  dtype=dtype, device=device, **kwargs)


def init_params(module: nn.Module, generator: torch.Generator,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random parameters for `module`, drawn on the generator's device from
    `generator`, at flax's initialisers: kernels lecun-normal (normal
    truncated at two standard deviations, std 1/sqrt(fan_in) after
    truncation; fan_in = in for a dense [in, out], in / groups x kh x kw
    for a conv OIHW), an LSTM's recurrent kernels orthogonal, embeddings
    normal with std 1/sqrt(features) (variance scaling 1.0 over the fan
    in), norm scales one, biases and DARTS's `alpha` zero."""
    dev = generator.device
    owners = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        w = torch.empty(p.shape, dtype=torch.float32, device=dev)
        if leaf == "kernel" and getattr(owners[owner], "recurrent", False):
            nn.init.orthogonal_(w, generator=generator)
        elif leaf == "kernel":
            fan_in = p.shape[0] if p.dim() == 2 else math.prod(p.shape[1:])
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif leaf == "embedding":
            nn.init.normal_(w, 0.0, 1.0 / math.sqrt(p.shape[-1]),
                            generator=generator)
        elif leaf == "scale":
            w.fill_(1.0)
        else:
            w.zero_()
        out[name] = w.to(dtype)
    return out


def params_from_flax(params, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """A flax parameter tree of this hub's models (nested dicts of arrays,
    with or without the top-level "params") -> this module's parameter
    dict: names joined with ".", conv kernels HWIO -> OIHW, dense kernels
    kept [in, out]; TransformerLM's `block_<i>` scopes become
    `blocks.<i>`."""
    dev = resolve_device(device)
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                k = str(k)
                if not prefix and re.fullmatch(r"block_\d+", k):
                    k = "blocks." + k[len("block_"):]
                walk(prefix + (k,), v)
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
