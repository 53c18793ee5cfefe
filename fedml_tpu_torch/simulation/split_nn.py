"""Split learning (SplitNN): the model cut at a layer between client and
server (port of `fedml_tpu/simulation/split_nn.py`; reference:
simulation/mpi/split_nn/SplitNNAPI.py:10-44, client.py, server.py).

The boundary is kept exactly: the server never sees client parameters or
raw inputs, and the client gets back only dL/dh. JAX's `jax.vjp` at the
cut is three steps here (`SplitStep`):

    client:  h = bottom(cp, x); h.detach() goes up        (activations)
    server:  loss of top(sp, h') on h' = the received h with
             requires_grad -> the server's gradients and dh = dL/dh'
    client:  the client's gradients = vjp of bottom at x against dh

so only h and dh cross the boundary. The relay ring (client k hands the
bottom weights to client k + 1, reference client_manager.py) is a loop
over the clients; both optimiser states persist across the ring.

Nets are modules of `models/hub.py`'s kind (parameter dicts applied
through `torch.func.functional_call`). Batch orders come from generators
keyed (seed, round, client) where JAX folds them into its key;
`run(batch_idx=)` takes them as a function of (round, client).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.algorithm import (
    make_batch_indices, make_client_optimizer, masked_softmax_ce,
)
from ..models import hub
from ..ops import keys


def _apply(module: torch.nn.Module) -> Callable:
    return lambda params, x: torch.func.functional_call(module, params, (x,))


def _grads(out, inputs: list, grad_out=None) -> list:
    """torch.autograd.grad with a zero gradient for an input the output
    does not use, as `jax.vjp` gives (a net may hold parameters its part
    of the split never reaches)."""
    gs = torch.autograd.grad(out, inputs, grad_out, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, inputs)]


class SplitStep:
    """One batch of split training in its three boundary-crossing steps
    (module docstring); `__call__` runs them in order."""

    def __init__(self, client_apply: Callable, server_apply: Callable,
                 client_opt, server_opt):
        self.client_apply, self.server_apply = client_apply, server_apply
        self.client_opt, self.server_opt = client_opt, server_opt

    def client_forward(self, cp: dict, x: torch.Tensor):
        """-> (h to send, detached; the client's context for backward)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in cp.items()}
        with torch.enable_grad():
            h = self.client_apply(leaves, x)
        return h.detach(), (leaves, h)

    def server_step(self, sp: dict, s_state, h: torch.Tensor, y, mask):
        """The server's loss on the received activations -> (new server
        params, state, dh, (loss, correct, count))."""
        hh = h.detach().requires_grad_(True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in sp.items()}
        with torch.enable_grad():
            loss, correct, cnt = masked_softmax_ce(
                self.server_apply(leaves, hh), y, mask)
            grads = _grads(loss, list(leaves.values()) + [hh])
        s_grads = dict(zip(leaves, grads[:-1]))
        sp, s_state = self.server_opt.step(sp, s_grads, s_state, 1)
        return sp, s_state, grads[-1], (loss.detach(), correct, cnt)

    def client_backward(self, cp: dict, c_state, ctx, dh: torch.Tensor):
        """The client's gradients from dh alone -> (new params, state)."""
        leaves, h = ctx
        grads = _grads(h, list(leaves.values()), dh)
        return self.client_opt.step(cp, dict(zip(leaves, grads)), c_state, 1)

    def __call__(self, cp, sp, c_state, s_state, batch):
        h, ctx = self.client_forward(cp, batch["x"])
        sp, s_state, dh, mets = self.server_step(sp, s_state, h, batch["y"],
                                                 batch["mask"])
        cp, c_state = self.client_backward(cp, c_state, ctx, dh)
        return cp, sp, c_state, s_state, mets


def make_split_step(client_apply: Callable, server_apply: Callable,
                    client_opt, server_opt) -> SplitStep:
    """One batch of split training; h up and dh down are the only tensors
    that cross between the parties."""
    return SplitStep(client_apply, server_apply, client_opt, server_opt)


class SplitNNRunner:
    """Relay-ring split training (reference: SplitNNAPI.py and the client
    and server managers): clients take turns; each trains `epochs` local
    epochs against the shared server top, then relays the bottom weights.
    `client_params` / `server_params` default to `hub.init_params` from
    generators seeded `seed` and `seed + 1`; `device` is CUDA unless the
    caller names "cpu"."""

    def __init__(self, client_net, server_net, data: dict,
                 lr: float = 0.1, batch_size: int = 16, epochs: int = 1,
                 seed: int = 0, client_params: Optional[dict] = None,
                 server_params: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.client_net, self.server_net = client_net, server_net
        self.data = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                     for k, v in data.items()}
        if "mask" not in self.data:
            self.data["mask"] = torch.ones(tuple(self.data["y"].shape),
                                           dtype=torch.float32,
                                           device=self.device)
        self.n_clients = int(self.data["y"].shape[0])
        self.batch_size, self.epochs, self.seed = batch_size, epochs, seed

        def init(net, given, s):
            if given is None:
                given = hub.init_params(net, torch.Generator().manual_seed(s))
            return {k: v.to(self.device) for k, v in given.items()}

        self.client_params = init(client_net, client_params, seed)
        self.server_params = init(server_net, server_params, seed + 1)
        self.c_opt = make_client_optimizer("sgd", lr)
        self.s_opt = make_client_optimizer("sgd", lr)
        self._step = make_split_step(_apply(client_net), _apply(server_net),
                                     self.c_opt, self.s_opt)
        self.history: list[dict] = []

    def run(self, rounds: int = 1,
            batch_idx: Optional[Callable] = None) -> list[dict]:
        """`rounds` passes of the relay ring; `batch_idx(r, k)`, when
        given, is client k's [steps, B] batch order in round r."""
        cp, sp = self.client_params, self.server_params
        c_state, s_state = self.c_opt.init(cp), self.s_opt.init(sp)
        s = int(self.data["y"].shape[1])
        for r in range(rounds):
            for k in range(self.n_clients):   # the relay ring
                shard = {key: v[k] for key, v in self.data.items()}
                idx = (batch_idx(r, k) if batch_idx is not None else
                       make_batch_indices(keys.generator((self.seed, r, k)),
                                          s, self.batch_size, self.epochs))
                idx = torch.as_tensor(np.array(idx)).to(self.device)
                mets = []
                for b in range(idx.shape[0]):
                    batch = {key: v[idx[b]] for key, v in shard.items()}
                    cp, sp, c_state, s_state, m = self._step(
                        cp, sp, c_state, s_state, batch)
                    mets.append(torch.stack([a.float() for a in m]))
                l, c, n = torch.stack(mets).double().cpu().unbind(1)
                tot = [float((l * n).sum()), float(c.sum()), float(n.sum())]
                self.history.append({
                    "round": r, "client": k,
                    "loss": tot[0] / max(tot[2], 1),
                    "acc": tot[1] / max(tot[2], 1)})
        self.client_params, self.server_params = cp, sp
        return self.history

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        h = _apply(self.client_net)(self.client_params, torch.as_tensor(
            np.asarray(x)).to(self.device))
        return _apply(self.server_net)(self.server_params, h).argmax(-1)
