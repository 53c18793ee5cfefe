"""Robust-aggregation defenses over the flat stacked updates (port of
`fedml_tpu/security/defenses.py`).

Every defense is a function of the update matrix U [m, D] (one row a
client) and the weights w [m]:
- reweighting (U, w) -> w': the krum selection, the 3-sigma family,
  FoolsGold, outlier detection, cross-round;
- aggregating (U, w) -> u_agg: median, trimmed mean, geometric median /
  RFA, bulyan, cclip, robust learning rate, residual reweighting;
- per update (u) -> u': norm clip, WBC, Soteria;
- after aggregation: SLSGD, CRFL.

What the JAX functions draw from a key, these take as an argument (the
noise), so a test can hand both the same draw. Order statistics follow
JAX's: a median of an even count is the mean of its two middle values
(`torch.median` would take the lower), and a selection breaks ties
towards the lower index, as `jax.lax.top_k` does (a stable sort; the
order of `torch.topk` on ties is not promised). Column-wise statistics
and per-row distances work on column chunks of `COLS`, so the flagship's
[100, 11.17M] stack never meets a second full-size temporary (a sort's
int64 indices alone would be twice its size). The gram matmul runs in
f32: nothing here enables TF32.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops.tree import tree_leaves, tree_map

Tree = Any
COLS = 1 << 19   # columns of U a chunked statistic holds at a time


# ------------------------------------------------------------- flat helpers
def _flat_base(leaves: list, m: int) -> Optional[torch.Tensor]:
    """The [m, D] matrix the stacked leaves are row-aligned views of, in
    order (the round's update buffer), or None."""
    base = leaves[0]._base
    if base is None or base.dim() != 2 or base.shape[0] < m:
        return None
    d, off, es = base.shape[1], 0, base.element_size()
    for l in leaves:
        n = l[0].numel() if l.dim() > 0 else 1
        if (l._base is not base or l.dtype != base.dtype or l.shape[0] != m
                or l.stride(0) != d or not l[0].is_contiguous()
                or l.data_ptr() != base.data_ptr() + off * es):
            return None
        off += n
    return base[:m] if off == d else None


def stack_flat(stacked: Tree) -> tuple[torch.Tensor, Callable]:
    """A tree of [m, ...] leaves -> (U [m, D], unflatten(u [D]) -> tree).
    Leaves that are views of one [m, D] matrix give that matrix, with no
    copy."""
    leaves = tree_leaves(stacked)
    m = leaves[0].shape[0]
    shapes = [tuple(l.shape[1:]) for l in leaves]
    sizes = [l[0].numel() for l in leaves]
    U = _flat_base(leaves, m)
    if U is None:
        U = torch.cat([l.reshape(m, -1) for l in leaves], dim=1)

    def unflatten(u: torch.Tensor) -> Tree:
        parts, off = [], 0
        for shape, size in zip(shapes, sizes):
            parts.append(u[off:off + size].reshape(shape))
            off += size
        it = iter(parts)
        return tree_map(lambda _l: next(it), stacked)

    return U, unflatten


def _chunks(D: int):
    for c0 in range(0, D, COLS):
        yield c0, min(c0 + COLS, D)


def _colwise(U: torch.Tensor, fn: Callable) -> torch.Tensor:
    """[D]: fn over column chunks of U ([m, c] -> [c])."""
    out = torch.empty(U.shape[1], dtype=U.dtype, device=U.device)
    for c0, c1 in _chunks(U.shape[1]):
        out[c0:c1] = fn(U[:, c0:c1])
    return out


def _sq_rows(U: torch.Tensor, center: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """[m]: sum over columns of (U - center)^2, chunk by chunk."""
    sq = torch.zeros(U.shape[0], dtype=U.dtype, device=U.device)
    for c0, c1 in _chunks(U.shape[1]):
        d = U[:, c0:c1] if center is None else U[:, c0:c1] - center[c0:c1]
        sq += (d * d).sum(1)
    return sq


def _row_dist(U: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """[m]: each row's L2 distance to `center`."""
    return torch.sqrt(_sq_rows(U, center))


def _median_sorted(s: torch.Tensor) -> torch.Tensor:
    """The median along dim 0 of sorted rows: the two middle order
    statistics' mean (jnp.median's midpoint)."""
    m = s.shape[0]
    return (s[(m - 1) // 2] + s[m // 2]) * 0.5


def _median1d(x: torch.Tensor) -> torch.Tensor:
    return _median_sorted(torch.sort(x).values)


def _wmean(U: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = w / torch.clamp(w.sum(), min=1e-12)
    return w @ U


def _pairwise_sqdist(U: torch.Tensor) -> torch.Tensor:
    """[m, m] squared euclidean distances: one gram matmul."""
    sq = _sq_rows(U)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (U @ U.T), min=0.0)


def _lowest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of a vector, ties to the lower
    index (jax.lax.top_k of -x)."""
    return torch.sort(x, stable=True).indices[:k]


# ----------------------------------------------------------- krum / bulyan
def krum_scores(U: torch.Tensor, num_byzantine: int) -> torch.Tensor:
    """Krum score: the sum of squared distances to the m - f - 2 nearest
    neighbours (Blanchard et al. 2017)."""
    m = U.shape[0]
    d2 = _pairwise_sqdist(U)
    d2.fill_diagonal_(float("inf"))
    k = max(1, m - num_byzantine - 2)
    return torch.sort(d2, dim=1).values[:, :k].sum(1)


def krum_select(U: torch.Tensor, num_byzantine: int, multi: bool = False,
                k: Optional[int] = None) -> torch.Tensor:
    """The rows krum (one) or multikrum (k, by default m - f) keeps, best
    score first."""
    scores = krum_scores(U, num_byzantine)
    if not multi:
        return torch.argmin(scores).reshape(1)
    return _lowest(scores, k or max(1, U.shape[0] - num_byzantine))


def krum(U: torch.Tensor, w: torch.Tensor, num_byzantine: int,
         multi: bool = False, k: Optional[int] = None) -> torch.Tensor:
    """krum: the best-scored update; multikrum: the weighted mean of the
    k best."""
    idx = krum_select(U, num_byzantine, multi, k)
    if not multi:
        return U[idx[0]]
    return _wmean(U.index_select(0, idx), w.index_select(0, idx))


def bulyan_select(U: torch.Tensor, num_byzantine: int) -> torch.Tensor:
    """Bulyan's multikrum selection of theta = m - 2f rows."""
    theta = max(1, U.shape[0] - 2 * num_byzantine)
    return _lowest(krum_scores(U, num_byzantine), theta)


def bulyan(U: torch.Tensor, w: torch.Tensor,
           num_byzantine: int) -> torch.Tensor:
    """Bulyan (Mhamdi et al. 2018): the multikrum selection of theta rows,
    then per coordinate the mean of the beta = theta - 2f values nearest
    the coordinate median (ties to the lower row)."""
    idx = bulyan_select(U, num_byzantine)
    beta = max(1, idx.numel() - 2 * num_byzantine)

    def cols(Uc):
        S = Uc.index_select(0, idx)
        med = _median_sorted(torch.sort(S, dim=0).values)
        sel = torch.sort(torch.abs(S - med[None, :]), dim=0,
                         stable=True).indices[:beta]
        return torch.gather(S, 0, sel).mean(0)

    return _colwise(U, cols)


# ------------------------------------------------- coordinate-wise statistics
def coordinate_median(U: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _colwise(U, lambda Uc: _median_sorted(torch.sort(Uc, dim=0).values))


def trimmed_mean(U: torch.Tensor, w: torch.Tensor,
                 trim_b: int) -> torch.Tensor:
    """The mean per coordinate after dropping the b largest and b smallest
    values."""
    m = U.shape[0]
    b = int(min(trim_b, (m - 1) // 2))
    if b == 0:
        return U.mean(0)
    return _colwise(U, lambda Uc: torch.sort(Uc, dim=0).values[b:m - b]
                    .mean(0))


def geometric_median(U: torch.Tensor, w: torch.Tensor, iters: int = 10,
                     eps: float = 1e-6) -> torch.Tensor:
    """Smoothed Weiszfeld (RFA, Pillutla et al.), `iters` steps from the
    weighted mean."""
    z = _wmean(U, w)
    for _ in range(iters):
        beta = w / torch.clamp(_row_dist(U, z), min=eps)
        z = (beta @ U) / torch.clamp(beta.sum(), min=1e-12)
    return z


rfa = geometric_median


# ---------------------------------------------------------------- filtering
def _mad_keep(scores: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w with the clients whose score passes median + 3 x 1.4826 MAD
    zeroed."""
    med = _median1d(scores)
    mad = torch.clamp(1.4826 * _median1d(torch.abs(scores - med)), min=1e-6)
    return w * (scores <= med + 3.0 * mad).to(w.dtype)


def three_sigma_weights(U: torch.Tensor, w: torch.Tensor,
                        center: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Each client scored by its distance to the center (the coordinate
    median by default); robust location and scale (median, MAD)."""
    c = coordinate_median(U, w) if center is None else center
    return _mad_keep(_row_dist(U, c), w)


def outlier_detection_weights(U: torch.Tensor, w: torch.Tensor,
                              k: int = 2) -> torch.Tensor:
    """Each client scored by its mean distance to its k nearest
    neighbours."""
    m = U.shape[0]
    d2 = _pairwise_sqdist(U)
    d2.fill_diagonal_(float("inf"))
    nearest = torch.sort(d2, dim=1).values[:, :min(k, m - 1)]
    return _mad_keep(torch.sqrt(nearest).mean(1), w)


def foolsgold_weights(history: torch.Tensor) -> torch.Tensor:
    """FoolsGold (Fung et al. 2020): per-client learning rates in [0, 1]
    from the cosine similarity of the clients' cumulative updates."""
    norms = torch.clamp(torch.linalg.vector_norm(history, dim=1,
                                                 keepdim=True), min=1e-12)
    hn = history / norms
    cs = hn @ hn.T
    del hn
    cs.fill_diagonal_(0.0)
    maxcs = cs.max(1).values
    # pardoning: rescale the similarities of honest clients
    pard = torch.where(
        maxcs[None, :] > maxcs[:, None],
        cs * (maxcs[:, None] / torch.clamp(maxcs[None, :], min=1e-12)), cs)
    wv = torch.clamp(1.0 - pard.max(1).values, 0.0, 1.0)
    wv = wv / torch.clamp(wv.max(), min=1e-12)
    wv = torch.where(wv == 1.0, 0.99, wv)
    lr = torch.log(wv / (1.0 - wv) + 1e-12) + 0.5
    return torch.clamp(lr, 0.0, 1.0)


def cross_round_weights(U: torch.Tensor, prev_U: torch.Tensor,
                        w: torch.Tensor, threshold: float = 0.0
                        ) -> torch.Tensor:
    """Clients whose update points away from their previous one (cosine
    below `threshold`) get weight 0; a client with no history keeps its
    weight."""
    num = torch.zeros(U.shape[0], dtype=U.dtype, device=U.device)
    for c0, c1 in _chunks(U.shape[1]):
        num += (U[:, c0:c1] * prev_U[:, c0:c1]).sum(1)
    pn = torch.sqrt(_sq_rows(prev_U))
    cos = num / torch.clamp(torch.sqrt(_sq_rows(U)) * pn, min=1e-12)
    keep = (cos >= threshold) | (pn < 1e-9)
    return w * keep.to(w.dtype)


# ------------------------------------------------------------- clipping family
def _clip_scale(norms: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)


def norm_clip_update(u: torch.Tensor, max_norm: float) -> torch.Tensor:
    """u scaled to an L2 norm of at most max_norm."""
    return u * _clip_scale(torch.linalg.vector_norm(u), max_norm)


def _shifted_wmean(U: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """_wmean of the rows (U - center) * scale, chunk by chunk."""
    wn = w / torch.clamp(w.sum(), min=1e-12)

    def cols(c0, c1):
        d = U[:, c0:c1] if center is None else U[:, c0:c1] - center[c0:c1]
        return wn @ (d * scale[:, None])

    out = torch.empty(U.shape[1], dtype=U.dtype, device=U.device)
    for c0, c1 in _chunks(U.shape[1]):
        out[c0:c1] = cols(c0, c1)
    return out


def clipped_mean(U: torch.Tensor, w: torch.Tensor,
                 max_norm: float) -> torch.Tensor:
    """The weighted mean of the rows, each clipped to norm max_norm."""
    return _shifted_wmean(U, w, _clip_scale(torch.sqrt(_sq_rows(U)),
                                            max_norm))


def weak_dp_aggregate(U: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
                      clip: float = 1.0, stddev: float = 0.025
                      ) -> torch.Tensor:
    """The clipped weighted mean plus stddev x `noise` (standard normal,
    [D])."""
    return clipped_mean(U, w, clip) + stddev * noise


def cclip(U: torch.Tensor, w: torch.Tensor, tau: float = 10.0,
          iters: int = 3, center: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Centered clipping (Karimireddy et al. 2021): v <- v + mean_i
    clip(u_i - v, tau)."""
    v = torch.zeros(U.shape[1], dtype=U.dtype, device=U.device) \
        if center is None else center
    for _ in range(iters):
        s = _clip_scale(_row_dist(U, v), tau)
        v = v + _shifted_wmean(U, w, s, v)
    return v


def robust_learning_rate_aggregate(U: torch.Tensor, w: torch.Tensor,
                                   threshold: float = 0.5) -> torch.Tensor:
    """Robust learning rate (Ozdayi et al. 2021): the weighted mean, its
    sign flipped on coordinates whose weighted sign vote is below
    threshold x sum(w)."""
    wsum = torch.clamp(w.sum(), min=1e-12)
    vote = torch.abs(_colwise(U, lambda Uc: w @ torch.sign(Uc)) / wsum)
    lr = torch.where(vote >= threshold, 1.0, -1.0).to(U.dtype)
    return lr * _wmean(U, w)


def residual_reweight_aggregate(U: torch.Tensor, w: torch.Tensor,
                                iters: int = 3, delta: float = 1e-6
                                ) -> torch.Tensor:
    """Residual-based reweighting (Fu et al. 2019) as IRLS on the update
    vector: clients reweighted by a Huber function of their residual to
    the current estimate, from the coordinate median."""
    z = coordinate_median(U, w)
    for _ in range(iters):
        r = _row_dist(U, z)
        s = torch.clamp(1.4826 * _median1d(r), min=delta)
        z = _wmean(U, w / torch.clamp(r / s, min=1.0))
    return z


# --------------------------------------------------------------- post-agg
def slsgd_postprocess(agg: torch.Tensor, prev_global: torch.Tensor,
                      alpha: float = 1.0) -> torch.Tensor:
    return (1.0 - alpha) * prev_global + alpha * agg


def crfl_postprocess(agg: torch.Tensor, noise: torch.Tensor,
                     clip: float = 15.0, sigma: float = 0.01
                     ) -> torch.Tensor:
    """CRFL (Xie et al. 2021): the aggregate clipped to norm `clip`, plus
    sigma x `noise` (standard normal)."""
    return norm_clip_update(agg, clip) + sigma * noise


def wbc_update_transform(u: torch.Tensor, laplace: torch.Tensor,
                         eta: float = 0.1, noise_std: float = 0.1
                         ) -> torch.Tensor:
    """FL-WBC (Sun et al. 2021): where |u| <= eta |noise| (noise =
    noise_std x `laplace`, standard Laplace), u + eta x noise."""
    noise = noise_std * laplace
    small = torch.abs(u) - eta * torch.abs(noise) <= 0.0
    return torch.where(small, u + eta * noise, u)


def soteria_update_transform(u: torch.Tensor,
                             prune_ratio: float = 0.5) -> torch.Tensor:
    """The largest-magnitude (1 - prune_ratio) share of u kept, the rest
    zeroed (ties to the lower index)."""
    k = max(1, int(u.numel() * (1.0 - prune_ratio)))
    idx = torch.sort(torch.abs(u), descending=True, stable=True).indices[:k]
    return torch.zeros_like(u).index_copy_(0, idx, u.index_select(0, idx))
