"""Classical vertical FL: feature-partitioned logistic regression (port of
`fedml_tpu/simulation/vertical.py`; reference:
simulation/sp/classical_vertical_fl/vfl.py, party_models.py).

The guest (party 0) holds the labels and the bias, the hosts disjoint
feature slices. Each step the parties' partial logits ("components") go
up, the guest sums them and takes the loss, and the common logit
gradient comes back; each party's gradient is that times its own
features. One step computes all of it on one device: the values that
would cross the wire are its intermediates.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops import keys


class VerticalFL:
    """Multi-party vertical logistic regression (reference:
    VerticalMultiplePartyLogisticRegressionFederatedLearning, vfl.py:1).
    `feature_dims` are the parties' feature widths, party 0 the guest;
    binary labels, BCE on one logit. Each party's w [d, 1] starts as
    0.01 N(0, 1) from the generator keyed (seed, party) (`params=`, a list
    of {"w"[, "b"]} dicts, takes given ones); plain SGD at `lr`; `device`
    is CUDA unless the caller names "cpu"."""

    def __init__(self, feature_dims: Sequence[int], lr: float = 0.05,
                 seed: int = 0, params: Optional[list] = None, device=None):
        self.device = resolve_device(device)
        self.dims = list(feature_dims)
        self.lr = lr
        if params is None:
            params = []
            for p, d in enumerate(self.dims):
                params.append({"w": 0.01 * torch.randn(
                    (d, 1), generator=keys.generator((seed, p))),
                    **({"b": torch.zeros(1)} if p == 0 else {})})
        self.params = [{k: torch.as_tensor(np.array(v), dtype=torch.float32)
                        .to(self.device) for k, v in p.items()}
                       for p in params]
        self.loss_trace: list[float] = []

    @staticmethod
    def _logit(params: list, xs: list) -> torch.Tensor:
        # the hosts' components and the guest's own partial logit
        comps = [x @ p["w"] for p, x in zip(params, xs)]
        return sum(comps)[:, 0] + params[0]["b"]

    def _step(self, xs: list, y: torch.Tensor):
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in self.params]
        with torch.enable_grad():
            logit = self._logit(leaves, xs)
            # BCE with logits in its stable form (the guest's loss)
            loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                              + torch.log1p(torch.exp(-logit.abs())))
            flat = [v for p in leaves for v in p.values()]
            grads = iter(torch.autograd.grad(loss, flat))
        self.params = [{k: v.detach() + next(grads) * (-self.lr)
                        for k, v in p.items()} for p in leaves]
        acc = ((logit.detach() > 0).float() == y).float().mean()
        return loss.detach(), acc

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def fit_batch(self, xs: Sequence[np.ndarray], y: np.ndarray) -> float:
        """One federated step on a batch: xs[p] is party p's feature slice
        of the same rows, y the guest's labels in {0, 1}."""
        loss, _acc = self._step([self._tensor(x) for x in xs],
                                self._tensor(y))
        self.loss_trace.append(float(loss))
        return self.loss_trace[-1]

    def fit(self, xs: Sequence[np.ndarray], y: np.ndarray,
            epochs: int = 10, batch_size: int = 64, seed: int = 0) -> None:
        n = y.shape[0]
        rs = np.random.RandomState(seed)
        for _ in range(epochs):
            order = rs.permutation(n)
            for s in range(0, n, batch_size):
                rows = order[s:s + batch_size]
                self.fit_batch([x[rows] for x in xs], y[rows])

    @torch.no_grad()
    def predict(self, xs: Sequence[np.ndarray]) -> np.ndarray:
        logit = self._logit(self.params, [self._tensor(x) for x in xs])
        return (logit > 0).cpu().numpy().astype(np.int32)
