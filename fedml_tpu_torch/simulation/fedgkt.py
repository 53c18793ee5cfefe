"""FedGKT, group knowledge transfer (He et al. 2020; port of
`fedml_tpu/simulation/fedgkt.py`; reference: simulation/mpi/fedgkt/).

Edge clients train a small net (feature extractor + classifier) with
CE + KD from the server's logits and ship (features, logits, labels);
the server trains a large net on the pooled features with CE + KD from
the clients' logits and returns fresh server logits for every client
sample. The edge never holds the big model.

- client phase: `torch.func.vmap` over the clients (randomness="error")
  of a loop over local steps, SGD with momentum 0.9 from a fresh state
  each round; loss = CE + alpha * KL(server logits || student), the KD
  term gated off while the teacher is all zeros (round 0); then one
  feature-extraction pass over each shard. The clients' parameters are
  averaged into the next round's shared edge start.
- server phase: SGD with momentum 0.9 (its state persists across rounds)
  over the pooled [N * S] transfer set in batches of 2 x batch_size,
  then the server's logits on every client sample.

Layers are `models/hub.py`'s (flax "SAME" convolutions, GroupNorm at
flax's eps, Dense [in, out]), with flax's parameter names, so
`hub.params_from_flax` carries the JAX nets' parameters across; the
modules take and return NHWC. Batch orders come from generators keyed
(seed, round, client) and (seed, round, `keys.SERVER`), where JAX folds
into its key; `run_round(client_idx=, server_idx=)` takes them instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..core.algorithm import (
    make_batch_indices, make_client_optimizer, masked_softmax_ce,
)
from ..models import hub
from ..ops import keys
from ..ops.tree import tree_map
from ..utils.events import recorder


class GKTClientNet(nn.Module):
    """The small edge model: two 3x3 convs (the first followed by a 2x2
    "VALID" max pool) and a linear head over the spatial mean. `part`
    picks `extract` (the feature maps), `classify` (the head on feature
    maps) or both, so `torch.func.functional_call` reaches each."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 features: int = 32, *, dtype=torch.float32, device=None):
        super().__init__()
        dev = hub._device(device)
        self.conv1 = hub.Conv(in_channels, features, 3, 1, True, dtype, dev)
        self.conv2 = hub.Conv(features, features, 3, 1, True, dtype, dev)
        self.head = hub.Dense(features, num_classes, dtype, dev)

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv1(x.permute(0, 3, 1, 2)))
        h = F.max_pool2d(h, 2, 2)
        return torch.relu(self.conv2(h)).permute(0, 2, 3, 1)

    def classify(self, h: torch.Tensor) -> torch.Tensor:
        return self.head(h.mean(dim=(1, 2)))

    def forward(self, x: torch.Tensor, dtype=None,
                part: str = "all") -> torch.Tensor:
        if part == "classify":
            return self.classify(x)
        h = self.extract(x)
        return h if part == "extract" else self.classify(h)


class GKTServerNet(nn.Module):
    """The large server model over client feature maps: `depth` residual
    blocks of two 3x3 convs with GroupNorm(8) (a 1x1 projection on the
    residual where the width changes), the spatial mean, Dense(2 width),
    Dense(classes). Names follow flax's compact numbering."""

    def __init__(self, num_classes: int, in_channels: int = 32,
                 width: int = 64, depth: int = 3, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        dev = hub._device(device)
        self.depth = depth
        self._blocks = []
        n_conv = n_gn = 0
        c = in_channels
        for _ in range(depth):
            names = [f"Conv_{n_conv}", f"GroupNorm_{n_gn}",
                     f"Conv_{n_conv + 1}", f"GroupNorm_{n_gn + 1}"]
            setattr(self, names[0], hub.Conv(c, width, 3, 1, True, dtype, dev))
            setattr(self, names[1], hub.GroupNorm(8, width, dtype, dev))
            setattr(self, names[2], hub.Conv(width, width, 3, 1, True, dtype,
                                             dev))
            setattr(self, names[3], hub.GroupNorm(8, width, dtype, dev))
            n_conv, n_gn = n_conv + 2, n_gn + 2
            proj = None
            if c != width:
                proj = f"Conv_{n_conv}"
                setattr(self, proj, hub.Conv(c, width, 1, 1, True, dtype,
                                             dev))
                n_conv += 1
            self._blocks.append((names, proj))
            c = width
        self.Dense_0 = hub.Dense(width, width * 2, dtype, dev)
        self.Dense_1 = hub.Dense(width * 2, num_classes, dtype, dev)

    def forward(self, h: torch.Tensor, dtype=None) -> torch.Tensor:
        h = h.permute(0, 3, 1, 2)
        for (c0, g0, c1, g1), proj in self._blocks:
            r = h
            h = torch.relu(getattr(self, g0)(getattr(self, c0)(h)))
            h = getattr(self, g1)(getattr(self, c1)(h))
            if proj is not None:
                r = getattr(self, proj)(r)
            h = torch.relu(h + r)
        h = torch.relu(self.Dense_0(h.mean(dim=(2, 3))))
        return self.Dense_1(h)


def kd_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
          temperature: float, mask: Optional[torch.Tensor] = None):
    """Temperature-scaled KL(teacher || student) up to the teacher's
    entropy, times T^2 (reference: fedgkt/utils.py KL_Loss); `mask` [B]
    takes padded rows out of the mean."""
    t = temperature
    p_t = torch.softmax(teacher_logits / t, -1)
    log_s = torch.log_softmax(student_logits / t, -1)
    per_row = -(p_t * log_s).sum(-1)
    if mask is None:
        return per_row.mean() * (t * t)
    return (per_row * mask).sum() / torch.clamp(mask.sum(), min=1.0) * (t * t)


def _call(module, params, x, **kw):
    return torch.func.functional_call(module, params, (x,), kw)


class FedGKTRunner:
    """Alternating client / server knowledge transfer over
    data = {"x": [N, S, H, W, C], "y": [N, S], "mask": [N, S]}.
    `client_params` / `server_params` default to `hub.init_params` from
    generators seeded `seed` and `seed + 1`; `device` is CUDA unless the
    caller names "cpu"."""

    def __init__(self, data: dict, num_classes: int,
                 client_net: Optional[GKTClientNet] = None,
                 server_net: Optional[GKTServerNet] = None,
                 lr: float = 0.02, batch_size: int = 16,
                 client_epochs: int = 1, server_epochs: int = 2,
                 kd_alpha: float = 0.5, temperature: float = 3.0,
                 seed: int = 0, client_params: Optional[dict] = None,
                 server_params: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.data = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                     for k, v in data.items()}
        self.n, self.s = self.data["y"].shape
        self.num_classes = num_classes
        self.kd_alpha, self.temperature = kd_alpha, temperature
        self.batch_size, self.client_epochs = batch_size, client_epochs
        self.server_epochs = server_epochs
        self.seed = seed
        c_in = self.data["x"].shape[-1]
        self.client_net = client_net or GKTClientNet(
            num_classes, c_in, device="meta")
        features = self.client_net.conv2.kernel.shape[0]
        self.server_net = server_net or GKTServerNet(
            num_classes, features, device="meta")

        def init(net, given, s):
            if given is None:
                given = hub.init_params(net, torch.Generator().manual_seed(s))
            return {k: v.to(self.device) for k, v in given.items()}

        self.client_params = init(self.client_net, client_params, seed)
        self.server_params = init(self.server_net, server_params, seed + 1)
        self.c_opt = make_client_optimizer("sgd", lr, 0.9)
        self.s_opt = make_client_optimizer("sgd", lr, 0.9)
        # the client optimizer starts fresh each round; the server's
        # state persists across rounds
        self._s_state = self.s_opt.init(self.server_params)
        self._s_steps = 0
        # server logits fed back to the clients, [N, S, K]; zeros in round 0
        self.server_logits = torch.zeros((self.n, self.s, num_classes),
                                         device=self.device)
        self.history: list[dict] = []
        self._client_vmap = torch.func.vmap(
            self._one_client, in_dims=(None, 0, 0, 0), randomness="error")

    # ---------------------------------------------------------- client side
    def _one_client(self, cp, shard, s_logits, idx):
        cn, alpha, T = self.client_net, self.kd_alpha, self.temperature

        def loss_fn(p, bx, by, bm, bt):
            logits = _call(cn, p, bx)
            loss, correct, n = masked_softmax_ce(logits, by, bm)
            # KD only once the server has spoken (round 0's teacher is all
            # zeros)
            has_teacher = (bt.abs().sum() > 0).to(loss.dtype)
            loss = loss + alpha * has_teacher * kd_kl(logits, bt, T, mask=bm)
            return loss, (loss, correct, n)

        grad = torch.func.grad(loss_fn, has_aux=True)
        st = self.c_opt.init(cp)
        p = cp
        sums = []
        for i in range(idx.shape[0]):
            bi = idx[i]
            g, (l, c, n) = grad(p, shard["x"][bi], shard["y"][bi],
                                shard["mask"][bi], s_logits[bi])
            p, st = self.c_opt.step(p, g, st, i + 1)
            sums.append(torch.stack([l * n, c, n]))
        feats = _call(cn, p, shard["x"], part="extract")
        logits = _call(cn, p, feats, part="classify")
        return p, feats, logits, torch.stack(sums).sum(0)

    def _client_phase(self, client_idx: torch.Tensor):
        cps, feats, logits, mets = self._client_vmap(
            self.client_params, self.data, self.server_logits, client_idx)
        # the clients' mean is the next round's shared edge start (the
        # reference keeps per-client weights; the mean keeps client state
        # O(1))
        self.client_params = tree_map(lambda a: a.mean(0), cps)
        return feats, logits, mets.sum(0)

    # ---------------------------------------------------------- server side
    def _server_phase(self, feats, c_logits, server_idx: torch.Tensor):
        sn, alpha, T = self.server_net, self.kd_alpha, self.temperature
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        fx, fy, fm, fl = (flat(feats), flat(self.data["y"]),
                          flat(self.data["mask"]), flat(c_logits))

        def loss_fn(p, bx, by, bm, bt):
            logits = _call(sn, p, bx)
            loss, correct, n = masked_softmax_ce(logits, by, bm)
            loss = loss + alpha * kd_kl(logits, bt, T, mask=bm)
            return loss, (loss, correct, n)

        grad = torch.func.grad(loss_fn, has_aux=True)
        p, st = self.server_params, self._s_state
        sums = []
        for i in range(server_idx.shape[0]):
            bi = server_idx[i]
            g, (l, c, n) = grad(p, fx[bi], fy[bi], fm[bi], fl[bi])
            self._s_steps += 1
            p, st = self.s_opt.step(p, g, st, self._s_steps)
            sums.append(torch.stack([l * n, c, n]))
        self.server_params, self._s_state = p, st
        # fresh teacher logits for every client sample
        with torch.no_grad():
            self.server_logits = _call(sn, p, fx).reshape(
                self.n, self.s, self.num_classes)
        return torch.stack(sums).sum(0)

    def draw_orders(self, round_idx: int):
        """(client orders [N, steps, B], server order [steps, 2B]) of a
        round, from the generators of the module docstring."""
        key = (self.seed, round_idx)
        client = torch.stack([make_batch_indices(
            keys.generator(keys.fold(key, i)), self.s, self.batch_size,
            self.client_epochs) for i in range(self.n)])
        server = make_batch_indices(
            keys.generator(keys.fold(key, keys.SERVER)), self.n * self.s,
            self.batch_size * 2, self.server_epochs)
        return client, server

    # -------------------------------------------------------------- driving
    def run_round(self, round_idx: int, client_idx=None,
                  server_idx=None) -> dict:
        if client_idx is None or server_idx is None:
            drawn = self.draw_orders(round_idx)
            client_idx = drawn[0] if client_idx is None else client_idx
            server_idx = drawn[1] if server_idx is None else server_idx
        ci, si = (torch.as_tensor(np.array(a)).to(self.device)
                  for a in (client_idx, server_idx))
        with recorder.span("gkt_client", round=round_idx):
            feats, logits, cm = self._client_phase(ci)
        with recorder.span("gkt_server", round=round_idx):
            sm = self._server_phase(feats, logits, si)
        cm, sm = (m.double().cpu().tolist() for m in (cm, sm))
        cn, sn_ = max(cm[2], 1.0), max(sm[2], 1.0)
        return {
            "round": round_idx,
            "client_loss": cm[0] / cn,
            "client_acc": cm[1] / cn,
            "server_loss": sm[0] / sn_,
            "server_acc": sm[1] / sn_,
        }

    def run(self, rounds: int) -> list[dict]:
        for r in range(rounds):
            row = self.run_round(r)
            self.history.append(row)
            recorder.log(row)
        return self.history

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        """End-to-end edge -> server inference."""
        x = torch.as_tensor(np.asarray(x)).to(self.device)
        h = _call(self.client_net, self.client_params, x, part="extract")
        return _call(self.server_net, self.server_params, h).argmax(-1)
