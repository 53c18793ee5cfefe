"""The security plugins' wiring from the config (port of
`fedml_tpu/security/__init__.py`).

Attacker and defender plug into the round as its FULL-mode hook,
`aggregate_full(stacked, weights, ctx) -> (agg, hook_state)`
(`parallel/round.py`), over the flat update matrix U [m, D]. In the hook:
the attack poisons U, the defense reweights or selects and aggregates;
SLSGD and CRFL post-process the aggregate (`postprocess_agg`), WBC and
Soteria each client's update (`postprocess_update`).

Stateful plugins keep their state in the hook state, which the round
threads from round to round and which these functions update in place:
FoolsGold's and cross-round's [client_num_in_total, D] history (one row
a client, `index_add_` / `index_copy_` of the cohort's rows) and the lazy
worker's [m, D] last updates. ctx holds "key" (the round's server key,
`ops/keys.py`), "ids" (the cohort's ids, a tensor on the device),
"state", "params" and, under chaos faults, "fault_keep".
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import Config, SecurityArgs
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map
from . import attacks as atk
from . import defenses as dfs

Tree = Any

DEFENSES = (
    "krum", "multikrum", "bulyan", "wise_median", "trimmed_mean", "geo_median",
    "rfa", "cclip", "norm_diff_clipping", "diff_clipping", "weak_dp",
    "robust_learning_rate", "slsgd", "crfl", "foolsgold", "3sigma",
    "3sigma_geo", "3sigma_foolsgold", "cross_round", "residual_reweight",
    "outlier_detection", "wbc", "soteria",
)
ATTACKS = ("byzantine", "label_flipping", "backdoor", "model_replacement",
           "edge_case_backdoor", "lazy_worker", "dlg", "invert_gradient",
           "revealing_labels")


def _flat_dim(params: Tree) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))


def _flat_one(tree: Tree):
    """A single (unstacked) tree as a vector, and its inverse."""
    U, unflat = dfs.stack_flat(tree_map(lambda x: x.unsqueeze(0), tree))
    return U[0], unflat


class FedAttacker:
    """Model and data poisoning for robustness tests."""

    def __init__(self, s: SecurityArgs, client_num_per_round: int):
        self.enabled = bool(s.enable_attack)
        self.type = (s.attack_type or "").lower()
        self.spec = dict(s.attack_spec)
        self.m = client_num_per_round

    def malicious_mask(self, m: int) -> np.ndarray:
        """The first `byzantine_client_num` of the m cohort slots."""
        n_mal = int(self.spec.get("byzantine_client_num", 1))
        mask = np.zeros(m, bool)
        mask[: min(n_mal, m)] = True
        return mask

    def poison_updates(self, U: torch.Tensor, w: torch.Tensor, ctx: dict,
                       state: Tree) -> tuple:
        """The attack on the flat stacked updates: (U', state)."""
        if not self.enabled:
            return U, state
        mal = torch.from_numpy(self.malicious_mask(U.shape[0])).to(U.device)
        if self.type == "byzantine":
            mode = self.spec.get("attack_mode", "random")
            evil = None
            if mode == "random":
                gen = keys.generator(keys.fold(ctx["key"], 0xA77), U.device)
                evil = torch.randn((int(mal.sum()), U.shape[1]),
                                   generator=gen, device=U.device)
            return atk.byzantine_attack(U, mal, mode, evil), state
        if self.type in ("model_replacement", "backdoor"):
            scale = float(self.spec.get("scale_factor", self.m))
            if self.type == "backdoor":
                # the scaled updates are those of the clients whose data
                # `poison_dataset` poisoned
                pids = torch.as_tensor(
                    list(self.spec.get("poisoned_client_ids", [0])),
                    device=U.device)
                mal = torch.isin(ctx["ids"], pids.to(ctx["ids"].dtype))
            return atk.model_replacement_attack(U, mal, scale), state
        if self.type == "lazy_worker":
            prev = state if state is not None else torch.zeros_like(U)
            out = atk.lazy_worker_attack(U, mal, prev)
            if state is None:
                return out, U.clone()
            state.copy_(U)   # this round's honest updates, next round's
            return out, state
        return U, state      # data-level attacks leave the updates alone

    def init_state(self, m: int, dim: int, device="cpu") -> Tree:
        if self.enabled and self.type == "lazy_worker":
            return torch.zeros((m, dim), dtype=torch.float32, device=device)
        return None

    def poison_dataset(self, data: dict, num_classes: int) -> dict:
        """The data-poisoning attacks, on the host arrays before upload."""
        if not self.enabled:
            return data
        cids = list(self.spec.get("poisoned_client_ids", [0]))
        if self.type == "label_flipping":
            return atk.poison_clients_data(
                data, cids, lambda x, y: (x, atk.label_flip(
                    y, num_classes, self.spec.get("original_class"),
                    self.spec.get("target_class"))))
        if self.type == "backdoor":
            target = int(self.spec.get("target_class", 0))
            return atk.poison_clients_data(
                data, cids, lambda x, y: atk.backdoor_trigger(x, y, target))
        if self.type == "edge_case_backdoor":
            # Attack of the Tails: poisoned clients swap part of their
            # data for the source class's low-density tail, relabelled
            from ..data.poison import edge_case_pool, replace_with_edge_cases

            target = int(self.spec.get("target_class", 0))
            source = int(self.spec.get("source_class", num_classes - 1))
            frac = float(self.spec.get("sample_frac", 0.5))
            tail = float(self.spec.get("tail_frac", 0.1))
            real = data["mask"].reshape(-1) > 0
            pool = edge_case_pool(
                data["x"].reshape((-1,) + data["x"].shape[2:])[real],
                data["y"].reshape(-1)[real], source, tail)
            out = {k: np.array(v) for k, v in data.items()}
            for i, c in enumerate(cids):
                out["x"][c], out["y"][c] = replace_with_edge_cases(
                    out["x"][c], out["y"][c], out["mask"][c], pool,
                    target, frac, seed=1000 + i)
            return out
        return data


class FedDefender:
    """The robust aggregation a config names."""

    def __init__(self, s: SecurityArgs, num_clients_total: int):
        self.enabled = bool(s.enable_defense)
        self.type = (s.defense_type or "").lower()
        self.spec = dict(s.defense_spec)
        self.n_total = num_clients_total
        if self.enabled and self.type not in DEFENSES:
            raise ValueError(
                f"unknown defense {self.type!r}; one of {DEFENSES}")

    @property
    def stateful(self) -> bool:
        return self.type in ("foolsgold", "3sigma_foolsgold", "cross_round")

    def init_state(self, dim: int, device="cpu") -> Tree:
        """FoolsGold and cross-round: a [client_num_in_total, D] history."""
        if self.enabled and self.stateful:
            return torch.zeros((self.n_total, dim), dtype=torch.float32,
                               device=device)
        return None

    def _aggregate(self, U, w, ctx, state):
        sp = self.spec
        f = int(sp.get("byzantine_client_num", max(1, U.shape[0] // 4)))
        t = self.type
        if t == "krum":
            return dfs.krum(U, w, f, multi=False), state
        if t == "multikrum":
            return dfs.krum(U, w, f, multi=True,
                            k=sp.get("krum_param_k")), state
        if t == "bulyan":
            return dfs.bulyan(U, w, f), state
        if t == "wise_median":
            return dfs.coordinate_median(U, w), state
        if t == "trimmed_mean":
            return dfs.trimmed_mean(U, w, int(sp.get("beta", f))), state
        if t in ("geo_median", "rfa"):
            return dfs.geometric_median(U, w, int(sp.get("iters", 10))), state
        if t == "cclip":
            return dfs.cclip(U, w, float(sp.get("tau", 10.0)),
                             int(sp.get("iters", 3))), state
        if t in ("norm_diff_clipping", "diff_clipping"):
            return dfs.clipped_mean(U, w, float(sp.get("norm_bound", 3.0))), \
                state
        if t == "weak_dp":
            gen = keys.generator(keys.fold(ctx["key"], 0xDEF), U.device)
            noise = torch.randn(U.shape[1], generator=gen, device=U.device)
            return dfs.weak_dp_aggregate(
                U, w, noise, float(sp.get("clip", 1.0)),
                float(sp.get("stddev", 0.025))), state
        if t == "robust_learning_rate":
            return dfs.robust_learning_rate_aggregate(
                U, w, float(sp.get("threshold", 0.5))), state
        if t == "residual_reweight":
            return dfs.residual_reweight_aggregate(U, w), state
        if t == "outlier_detection":
            return dfs._wmean(U, dfs.outlier_detection_weights(U, w)), state
        if t == "3sigma":
            return dfs._wmean(U, dfs.three_sigma_weights(U, w)), state
        if t == "3sigma_geo":
            w2 = dfs.three_sigma_weights(U, w, dfs.geometric_median(U, w))
            return dfs._wmean(U, w2), state
        ids = ctx["ids"]
        if t in ("foolsgold", "3sigma_foolsgold"):
            state.index_add_(0, ids, U)
            w2 = w * dfs.foolsgold_weights(state.index_select(0, ids))
            if t == "3sigma_foolsgold":
                w2 = dfs.three_sigma_weights(U, w2)
            return dfs._wmean(U, w2), state
        if t == "cross_round":
            w2 = dfs.cross_round_weights(U, state.index_select(0, ids), w,
                                         float(sp.get("threshold", 0.0)))
            agg = dfs._wmean(U, w2)
            state.index_copy_(0, ids, U)
            return agg, state
        if t == "slsgd":
            b = int(sp.get("trim_param_b", 0))
            return (dfs.trimmed_mean(U, w, b) if b else dfs._wmean(U, w)), \
                state
        if t in ("wbc", "soteria"):   # client-side; a plain mean here
            return dfs._wmean(U, w), state
        raise ValueError(f"defense {t!r} not dispatchable")

    def update_transform(self) -> Optional[Callable]:
        """The client-side defenses: (update, key) -> update."""
        if not self.enabled:
            return None
        sp = self.spec
        if self.type == "wbc":
            from ..dp.mechanisms import draw_laplace

            def f(upd, key):
                u, unflat = _flat_one(upd)
                lap = draw_laplace(keys.generator(key, u.device), u)
                return unflat(dfs.wbc_update_transform(
                    u, lap, float(sp.get("eta", 0.1)),
                    float(sp.get("noise_std", 0.1))))
            return f
        if self.type == "soteria":
            def f(upd, key):
                u, unflat = _flat_one(upd)
                return unflat(dfs.soteria_update_transform(
                    u, float(sp.get("prune_ratio", 0.5))))
            return f
        return None

    def postprocess_agg(self) -> Optional[Callable[[Tree, dict], Tree]]:
        """The aggregate's post-processing (SLSGD, CRFL)."""
        if not self.enabled:
            return None
        sp = self.spec
        if self.type == "slsgd":
            alpha = float(sp.get("alpha", 1.0))
            # the aggregate is a delta: the moving average scales it
            return lambda agg, ctx: tree_map(lambda a: alpha * a, agg)
        if self.type == "crfl":
            clip, sigma = float(sp.get("clip", 15.0)), \
                float(sp.get("sigma", 0.01))

            def f(agg, ctx):
                u, unflat = _flat_one(agg)
                gen = keys.generator(keys.fold(ctx["key"], 0xCF1), u.device)
                noise = torch.randn(u.shape, generator=gen, device=u.device)
                return unflat(dfs.crfl_postprocess(u, noise, clip, sigma))
            return f
        return None


def build_server_pipeline(attacker: FedAttacker,
                          defender: FedDefender) -> Optional[Callable]:
    """Attack then defense as the round's aggregate_full hook; None when
    neither needs the whole update set."""
    need_full = (attacker.enabled and attacker.type in
                 ("byzantine", "model_replacement", "backdoor",
                  "lazy_worker")) \
        or (defender.enabled and defender.type not in ("wbc", "soteria"))
    if not need_full:
        return None

    def aggregate_full(stacked: Tree, weights: torch.Tensor, ctx: dict):
        U, unflat = dfs.stack_flat(stacked)
        st = ctx["state"] if isinstance(ctx["state"], dict) \
            else {"atk": None, "dfs": ctx["state"]}
        U, atk_st = attacker.poison_updates(U, weights, ctx, st.get("atk"))
        dfs_st = st.get("dfs")
        if defender.enabled:
            agg, dfs_st = defender._aggregate(U, weights, ctx, dfs_st)
        else:
            agg = dfs._wmean(U, weights)
        return unflat(agg), {"atk": atk_st, "dfs": dfs_st}

    return aggregate_full


def init_pipeline_state(attacker: FedAttacker, defender: FedDefender,
                        params: Tree, client_num_per_round: int,
                        device="cpu") -> Tree:
    dim = _flat_dim(params)
    return {"atk": attacker.init_state(client_num_per_round, dim, device),
            "dfs": defender.init_state(dim, device)}


def from_config(cfg: Config) -> tuple[FedAttacker, FedDefender]:
    t = cfg.train_args
    return (FedAttacker(cfg.security_args, t.client_num_per_round),
            FedDefender(cfg.security_args, t.client_num_in_total))
