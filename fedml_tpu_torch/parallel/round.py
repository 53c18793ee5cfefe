"""The federated round on one device (port of the single-device LINEAR
path of `fedml_tpu/parallel/round.py`: `make_round_parts`,
`build_round_fn`, `build_block_fn`, `build_chunk_fns`).

    round_fn(server_state, client_states, data, ids, weights, seed,
             batch_idx=None, hook_state=None, faults=None) -> RoundOutput

data = {"x": [N, S, ...], "y": [N, S, ...], "mask": [N, S]} on the device;
ids [m] are the sampled clients (host integers), weights [m] their
aggregation weights. The clients train in G-way groups, in id order
(`run_clients_acc` of the JAX round): g is the largest divisor of the
cohort (of the chunk, when chunked) that is at most `group_size`, and each
group is one `torch.func.vmap` of `alg.client_update` over (shard, client
state, batch order), the broadcast unbatched; a group of one calls the
client directly. Each group's weight-premultiplied sum folds into the
carry, num + sum_g(u * w) and den + sum_g(w), in that order, so a chunk
boundary cannot change the order of the additions; the aggregate
num / max(den, 1e-12) goes to `alg.server_update`. Client i's batch order
is `batch_idx[i]` ([steps, B]) when given, else `alg.schedule` of a
`torch.Generator` seeded from (seed..., ids[i]) (`seed` an int or a tuple
of ints, such as the Simulator's (random_seed, round)); it is drawn on the
host, outside vmap. Metrics: train_loss, train_acc and n_samples over the
clients with weight > 0; with `health_stats`, also metrics["health"] =
{"update_norm", "cosine", "loss_delta"}, [m] f32 each (`_client_health`).
Health keeps every client's update, stacked per leaf ([m, ...]), until
the round ends: m x the update's size of device memory.

Per-client state (`alg.client_state_init`: SCAFFOLD, FedDyn) is stacked
[N, ...] per leaf on the device. A round gathers its cohort's states at
the start, buffers the new ones and scatters them once, at the end, into
`client_states` in place (the JAX round donates them): a mesh or chunk
pad, a zero-weight duplicate of an id, then recomputes from its source's
pre-round state, never from an updated one, and the scatter writes each
id's first row. Unsampled clients' states are untouched. Algorithms
without state pass `client_states` (None) through.

The round is split as the JAX round is (`RoundParts`): `zero_carry`, one
`chunk_body` per chunk of the cohort, `finalize_body`. The single-shot
round is the three in a row, so the chunked round (`build_chunk_fns`)
runs exactly its arithmetic. `build_block_fn` runs K rounds back to back
with no host synchronisation between them and returns their metrics
stacked [K]. Host arrays reach the card through pinned memory without a
synchronising copy.

The round's plugins (`make_round_parts`) have the JAX round's hook sites:
- `postprocess_update(update, key)` on each client's update before it is
  weighted (client-side defenses, compression, local DP), and an
  algorithm's `finish_update` (EF-TopK) before it; both run for each
  client outside torch.func.vmap, after its group returns, so they may
  draw noise: client i's key is (seed..., ids[i]) (`ops/keys.py`), the
  same in a chunk as in the single-shot round;
- `aggregate_full(stacked, weights, ctx) -> (aggregate, hook_state)`,
  FULL mode (robust defenses, model-poisoning attacks): every update is
  buffered, [m, ...] a leaf as views into one [m, D] matrix, across
  chunks, the weighted sums are not kept, and the hook sees the real
  prefix of `num_real_clients` rows (pads are never part of its
  statistics). ctx = {"key": the round's server key (seed...,
  keys.SERVER), "ids", "state": the hook state, "params"}, with
  "fault_keep" under chaos faults;
- `postprocess_agg(aggregate, ctx)` before the server step.
The hook state is threaded from round to round (the plugins update it in
place). Chaos client faults (`client_dropout`, `client_straggler`) draw
each client's fate on the host from (seed..., id, 0xFA17, salt), so a
chunk draws what the single-shot round draws; dropped and straggled are
disjoint. A faulted client still trains, but its weight is zeroed (the
weighted paths reweight over the survivors), its metrics leave the
round's, and its persistent state keeps its pre-round value;
metrics["faults"] = {"dropped", "straggled"} ([m] f32 0/1). The tests
hand the JAX round's masks over as `faults=`.

A mesh raises NotImplementedError naming its ROADMAP port-queue item
(4), as does a group of clients that `torch.func.vmap` cannot batch
(item 3d.1b).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.algorithm import FedAlgorithm, ServerState
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map, tree_vdot


class RoundOutput(NamedTuple):
    server_state: ServerState
    client_states: Any
    metrics: dict
    hook_state: Any = None


def client_generator(seed, client_id: int) -> torch.Generator:
    """A CPU generator seeded from the key (seed..., client id): numpy's
    SeedSequence mixes them into the 32 bits the generator reads. `seed`
    is an int or a sequence of ints."""
    return keys.generator(keys.fold(seed, client_id))


def draw_schedules(alg: FedAlgorithm, seed, ids, shard_size: int):
    """[m, steps, B] int64 on the host: each client's batch order drawn
    from `client_generator(seed, id)`."""
    return torch.stack([alg.schedule(client_generator(seed, c), shard_size)
                        for c in np.asarray(ids).tolist()])


def fault_masks(seed, ids, client_dropout: float, client_straggler: float):
    """(dropped, straggled), [m] bool on the host: client c is dropped with
    probability `client_dropout` by the generator of (seed..., c, 0xFA17,
    1), and straggles with probability `client_straggler` by that of
    (seed..., c, 0xFA17, 2) unless it was dropped."""
    def draw(rate, salt):
        if rate <= 0.0:
            return np.zeros(len(ids), bool)
        return np.array([torch.rand((), generator=keys.generator(
            keys.fold(seed, c, 0xFA17, salt))).item() < rate
            for c in np.asarray(ids).tolist()], bool)

    dropped = draw(client_dropout, 1)
    return dropped, draw(client_straggler, 2) & ~dropped


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array or tensor on `device`. To the card it goes through
    pinned memory with a non-blocking copy, so the host does not wait for
    the work already queued there."""
    t = torch.as_tensor(a)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def group_width(m: int, group_size: int) -> int:
    """The largest divisor of m that is at most group_size (the JAX
    round's g: m = 100 at G = 8 gives 5)."""
    g = max(1, min(group_size, m))
    while m % g:
        g -= 1
    return g


def _client_health(upds, agg, loss_per_client: torch.Tensor,
                   loss_sum: torch.Tensor, count: torch.Tensor) -> dict:
    """Per-client run-health stats (`fedml_tpu/parallel/round.py:72`):
    update_norm, the L2 norm of each client's update; cosine, its cosine
    with the aggregate (before any post-processing); loss_delta, each
    client's mean training loss minus the cohort's. `upds` holds the
    stacked [m, ...] updates; every sum is in f32."""
    m = loss_per_client.shape[0]
    sq = torch.zeros(m, dtype=torch.float32, device=loss_per_client.device)
    dots = torch.zeros_like(sq)
    for u, a in zip(tree_leaves(upds), tree_leaves(agg)):
        u2 = u.reshape(m, -1).float()
        sq += torch.bmm(u2[:, None, :], u2[:, :, None]).reshape(m)
        dots += u2 @ a.reshape(-1).float()
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    agg_norm = torch.sqrt(torch.clamp(tree_vdot(agg, agg), min=0.0))
    cosine = dots / torch.clamp(norms * agg_norm, min=1e-12)
    cohort = loss_sum.float() / torch.clamp(count, min=1.0)
    return {"update_norm": norms, "cosine": cosine,
            "loss_delta": loss_per_client - cohort}


def _update_buffer(upd, m: int):
    """Room for the round's [m, ...] updates, leaf by leaf: views into one
    [m, D] matrix when every leaf has one dtype (the FULL-mode hook's U,
    no copy: `security.defenses.stack_flat`), else a buffer a leaf. `upd`
    is one group's updates."""
    leaves = tree_leaves(upd)
    if any(x.dtype != leaves[0].dtype for x in leaves):
        return tree_map(lambda u: torch.empty(
            (m,) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device), upd)
    sizes = [x[0].numel() for x in leaves]
    flat = torch.empty((m, sum(sizes)), dtype=leaves[0].dtype,
                       device=leaves[0].device)
    offs = iter(np.cumsum([0] + sizes[:-1]).tolist())

    def view(u):
        o = next(offs)
        return flat[:, o:o + u[0].numel()].view((m,) + tuple(u.shape[1:]))

    return tree_map(view, upd)


def _per_client(upd, states, seed, cids, finish, post):
    """The steps each client takes outside vmap, with its key (seed...,
    id): the algorithm's `finish_update`, then `postprocess_update`.
    `upd` and `states` (or None) are one group's, [g, ...] a leaf."""
    us, ss = [], []
    for i, c in enumerate(np.asarray(cids).tolist()):
        key = keys.fold(seed, c)
        u = tree_map(lambda a: a[i], upd)
        st = None if states is None else tree_map(lambda a: a[i], states)
        if finish is not None:
            u, st = finish(u, st, key)
        if post is not None:
            u = post(u, key)
        us.append(u)
        ss.append(st)

    def stack(xs):
        return tree_map(lambda *a: torch.stack(a), *xs)

    return stack(us), None if states is None else stack(ss)


class RoundParts(NamedTuple):
    """The round in its chunk-streamable pieces (module docstring)."""
    zero_carry: Callable      # (client_states, ids, device) -> carry
    chunk_body: Callable      # (carry, server_state, data, rows, ids, w,
    #                            seed, off, batch_idx=None, faults=None)
    #                            -> carry
    finalize_body: Callable   # (server_state, carry, ids, hook_state=None)
    #                            -> RoundOutput
    round_body: Callable      # the single-shot round (round_fn)


def _refuse(alg: FedAlgorithm, mesh, group_size: int) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "round over a device mesh is not ported yet (ROADMAP 'Port "
            "queue' item 4, multi-GPU)")
    if group_size > 1 and not alg.vmap_ok:
        raise NotImplementedError(
            "group_size > 1 for a client torch.func.vmap cannot batch (the "
            "FedLLM LoRA round: its flash autograd.Function has no vmap "
            "rule and its per-block remat no torch.func.grad): not ported "
            "yet (ROADMAP 'Port queue' item 3d.1b)")


def make_round_parts(alg: FedAlgorithm, group_size: int = 1,
                     health_stats: bool = False, *,
                     aggregate_full: Optional[Callable] = None,
                     postprocess_update: Optional[Callable] = None,
                     postprocess_agg: Optional[Callable] = None,
                     num_real_clients: Optional[int] = None,
                     client_dropout: float = 0.0,
                     client_straggler: float = 0.0) -> RoundParts:
    """The round's pieces (module docstring), shared by `build_round_fn`,
    `build_block_fn` and `build_chunk_fns`."""
    use_full = aggregate_full is not None
    collect = use_full or health_stats
    has_cstate = alg.client_state_init is not None
    chaos_on = client_dropout > 0.0 or client_straggler > 0.0
    per_client = alg.finish_update is not None \
        or postprocess_update is not None

    def one_client(bcast, shard, cstate, batch_idx):
        upd, new_state, met = alg.client_update(bcast, shard, cstate,
                                                batch_idx)
        out = (upd, (met.loss_sum, met.correct, met.count))
        return out + (new_state,) if has_cstate else out

    def run_group(bcast, shards, cstates, batch_idx, g):
        """One group: (updates, (loss_sum, correct, count), new states or
        None), every leaf with a leading [g] axis."""
        if g == 1:
            first = (lambda t: tree_map(lambda a: a[0], t))
            out = tree_map(lambda a: a.unsqueeze(0), one_client(
                bcast, first(shards), first(cstates) if has_cstate else None,
                batch_idx[0]))
        else:
            out = torch.func.vmap(
                one_client, in_dims=(None, 0, 0 if has_cstate else None, 0),
                randomness="error")(bcast, shards, cstates, batch_idx)
        return out if has_cstate else out + (None,)

    def zero_carry(full_cstates, ids, device) -> dict:
        """The carry at the start of a round: the weighted sums (allocated
        by the first group), the metric sums, the client-state plane (the
        cohort's states gathered here, at round start, and a buffer for
        the new ones), the host's weights and fault masks."""
        m = len(ids)
        carry = {"m": m, "num": None, "msum": None, "seed": None,
                 "den": torch.zeros((), dtype=torch.float32, device=device),
                 "w": np.zeros(m, np.float32), "cstates": full_cstates,
                 "bufs": {}}
        if chaos_on:
            carry["faults"] = {"dropped": np.zeros(m, bool),
                               "straggled": np.zeros(m, bool)}
        if has_cstate:
            rows = to_device(np.asarray(ids, np.int64), device)
            cs = tree_map(lambda a: a.index_select(0, rows), full_cstates)
            carry["bufs"]["cs"] = cs
            carry["bufs"]["ns"] = tree_map(torch.empty_like, cs)
        if health_stats:
            carry["bufs"]["loss"] = torch.zeros(m, dtype=torch.float32,
                                                device=device)
        return carry

    def chunk_body(carry: dict, server_state: ServerState, data: dict, rows,
                   ids, weights, seed, off: int, batch_idx=None,
                   faults=None) -> dict:
        """Fold the clients `ids` (host ints, the data's rows `rows`) into
        the carry, in groups; `off` is their first row in the round's
        buffers. `batch_idx` ([c, steps, B]) or `alg.schedule` gives each
        client's batch order; `faults` ({"dropped", "straggled"} [c] 0/1),
        when given, replaces the chaos draws."""
        bcast = alg.broadcast(server_state)
        dev = data["y"].device
        ids = np.asarray(ids)
        c = len(ids)
        g = group_width(c, group_size)
        weights = np.asarray(weights, np.float32)
        carry["seed"] = seed
        if chaos_on:
            if faults is None:
                dropped, straggled = fault_masks(
                    seed, ids, client_dropout, client_straggler)
            else:
                dropped = np.asarray(faults["dropped"]) > 0.5
                straggled = (np.asarray(faults["straggled"]) > 0.5) \
                    & ~dropped
            carry["faults"]["dropped"][off:off + c] = dropped
            carry["faults"]["straggled"][off:off + c] = straggled
            keep = ~(dropped | straggled)
            # a lost report: zero weight on every weighted path
            weights = weights * keep
            keep_dev = to_device(keep, dev)
        carry["w"][off:off + c] = weights
        w_all = to_device(weights, dev)
        if batch_idx is None:
            batch_idx = draw_schedules(alg, seed, ids, data["y"].shape[1])
        elif not isinstance(batch_idx, torch.Tensor):
            batch_idx = torch.stack([torch.as_tensor(b) for b in batch_idx])
        batch_idx = to_device(batch_idx, dev)
        rows = np.asarray(rows, np.int64)
        rows_dev = None if g == 1 else to_device(rows, dev)
        bufs = carry["bufs"]
        for j in range(c // g):
            lo, hi = j * g, (j + 1) * g
            if g == 1:   # a view of the client's rows, no copy
                shards = {k: v[int(rows[lo])].unsqueeze(0)
                          for k, v in data.items()}
            else:
                shards = {k: v.index_select(0, rows_dev[lo:hi])
                          for k, v in data.items()}
            cs = (tree_map(lambda a: a[off + lo:off + hi], bufs["cs"])
                  if has_cstate else None)
            upd, mets, ns = run_group(bcast, shards, cs,
                                      batch_idx[lo:hi], g)
            if per_client:
                upd, ns = _per_client(upd, ns, seed, ids[lo:hi],
                                      alg.finish_update, postprocess_update)
            if chaos_on and has_cstate:
                # a faulted client's state keeps its pre-round value
                kp = keep_dev[lo:hi]
                ns = tree_map(lambda n, o: torch.where(
                    kp.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), ns, cs)
            w = w_all[lo:hi]
            # zero-weight clients (pads, faulted clients) are out of the
            # reported metrics
            live = (w > 0).float()
            mets = [a * live.to(a.dtype) for a in mets]
            if carry["msum"] is None:
                carry["msum"] = [torch.zeros_like(a[0]) for a in mets]
            carry["msum"] = [s + a.sum(0) for s, a in
                             zip(carry["msum"], mets)]
            if not use_full:
                gsum = tree_map(lambda u: (u * w.reshape(
                    (-1,) + (1,) * (u.dim() - 1)).to(u.dtype)).sum(0), upd)
                if carry["num"] is None:
                    carry["num"] = tree_map(torch.zeros_like, gsum)
                carry["num"] = tree_map(torch.add, carry["num"], gsum)
                carry["den"] = carry["den"] + w.sum()
            if has_cstate:
                tree_map(lambda b, n: b[off + lo:off + hi].copy_(n),
                         bufs["ns"], ns)
            if collect:
                if "u" not in bufs:
                    bufs["u"] = _update_buffer(upd, carry["m"])
                tree_map(lambda b, u: b[off + lo:off + hi].copy_(u),
                         bufs["u"], upd)
            if health_stats:
                bufs["loss"][off + lo:off + hi] = (
                    mets[0].float() / torch.clamp(mets[2], min=1.0))
        return carry

    def finalize_body(server_state: ServerState, carry: dict, ids,
                      hook_state=None) -> RoundOutput:
        """Close the round: the aggregate (FULL mode: the hook over the
        buffered updates), its post-processing, the server step, the
        metrics row, and the one client-state scatter."""
        dev = carry["den"].device
        m = carry["m"]
        ids_dev = to_device(np.asarray(ids, np.int64), dev)
        ctx = {"key": keys.fold(carry["seed"], keys.SERVER), "ids": ids_dev,
               "state": hook_state, "params": server_state.params}
        if chaos_on:
            f = carry["faults"]
            ctx["fault_keep"] = to_device(~(f["dropped"] | f["straggled"]),
                                          dev)
        if use_full:
            u, w = carry["bufs"]["u"], to_device(carry["w"], dev)
            cx = ctx
            mr = num_real_clients
            if mr is not None and mr < m:
                # pads must not bias unweighted statistics (krum's
                # distances, medians): the hook sees the real prefix
                u = tree_map(lambda a: a[:mr], u)
                w = w[:mr]
                cx = {**ctx, "ids": ids_dev[:mr]}
                if chaos_on:
                    cx["fault_keep"] = ctx["fault_keep"][:mr]
            agg, hook_state = aggregate_full(u, w, cx)
        else:
            den = torch.clamp(carry["den"], min=1e-12)
            agg = tree_map(lambda a: a / den.to(a.dtype), carry["num"])
        loss_sum, correct, count = carry["msum"]
        n = torch.clamp(count, min=1.0)
        metrics = {"train_loss": loss_sum / n, "train_acc": correct / n,
                   "n_samples": count}
        if health_stats:
            metrics["health"] = _client_health(
                carry["bufs"]["u"], agg, carry["bufs"]["loss"], loss_sum,
                count)
        if chaos_on:
            metrics["faults"] = {
                k: to_device(v.astype(np.float32), dev)
                for k, v in carry["faults"].items()}
        if postprocess_agg is not None:
            agg = postprocess_agg(agg, ctx)
        new_server = alg.server_update(server_state, agg)
        full = carry["cstates"]
        if has_cstate:
            # each id's first row: a pad duplicate's recompute never wins
            uniq, first = np.unique(np.asarray(ids, np.int64),
                                    return_index=True)
            sdev = tree_leaves(full)[0].device
            dst, src = to_device(uniq, sdev), to_device(first, sdev)
            tree_map(lambda f, n: f.index_copy_(0, dst,
                                                n.index_select(0, src)),
                     full, carry["bufs"]["ns"])
        return RoundOutput(new_server, full, metrics, hook_state)

    def round_body(server_state: ServerState, client_states, data: dict,
                   ids, weights, seed, batch_idx=None, hook_state=None,
                   faults=None) -> RoundOutput:
        ids = np.asarray(ids)
        carry = zero_carry(client_states, ids, data["y"].device)
        carry = chunk_body(carry, server_state, data, ids, ids, weights, seed,
                           0, batch_idx, faults)
        return finalize_body(server_state, carry, ids, hook_state)

    return RoundParts(zero_carry, chunk_body, finalize_body, round_body)


def build_round_fn(alg: FedAlgorithm, mesh=None, group_size: int = 1,
                   postprocess_update=None, postprocess_agg=None,
                   health_stats: bool = False, client_dropout: float = 0.0,
                   client_straggler: float = 0.0, aggregate_full=None,
                   num_real_clients: Optional[int] = None) -> Callable:
    """The single-round function (module docstring has its contract)."""
    _refuse(alg, mesh, group_size)
    return make_round_parts(
        alg, group_size, health_stats, aggregate_full=aggregate_full,
        postprocess_update=postprocess_update,
        postprocess_agg=postprocess_agg, num_real_clients=num_real_clients,
        client_dropout=client_dropout,
        client_straggler=client_straggler).round_body


def build_block_fn(alg: FedAlgorithm, group_size: int = 1,
                   health_stats: bool = False, **plugins) -> Callable:
    """K rounds back to back over the round body (`plugins`: the keyword
    arguments of `make_round_parts`):

        block_fn(server_state, client_states, data, ids [K, m],
                 weights [K, m], seed, rounds [K], batch_idx=None,
                 hook_state=None, faults=None)
            -> RoundOutput with metrics stacked [K] ([K, m] for health
               and faults)

    Round k's seed is (seed, rounds[k]), the one the Simulator's
    per-round loop gives it; `batch_idx[k]` and `faults[k]`, when given,
    are its schedule and fault masks.
    Nothing in the block waits for the card: the host queues the K rounds
    and the caller fetches the stacked metrics in one transfer."""
    round_body = make_round_parts(alg, group_size, health_stats,
                                  **plugins).round_body

    def block_fn(server_state, client_states, data, ids, weights, seed,
                 rounds, batch_idx=None, hook_state=None,
                 faults=None) -> RoundOutput:
        rows = []
        for k, r in enumerate(rounds):
            out = round_body(server_state, client_states, data, ids[k],
                             weights[k], (seed, int(r)),
                             None if batch_idx is None else batch_idx[k],
                             hook_state,
                             None if faults is None else faults[k])
            server_state, client_states = out.server_state, out.client_states
            hook_state = out.hook_state
            rows.append(out.metrics)
        return RoundOutput(server_state, client_states,
                           stack_metrics(rows), hook_state)

    return block_fn


def stack_metrics(rows: list) -> dict:
    """Rounds' metric trees stacked leaf by leaf: [K, ...]."""
    if isinstance(rows[0], dict):
        return {k: stack_metrics([r[k] for r in rows]) for k in rows[0]}
    return torch.stack(rows)


def build_chunk_fns(alg: FedAlgorithm, group_size: int = 1,
                    health_stats: bool = False, **plugins):
    """The round split over chunks of the cohort (the JAX
    `build_chunk_fns`; `plugins`: the keyword arguments of
    `make_round_parts`): (chunk_fn, finalize_fn, make_carry) with

        make_carry(client_states, ids, device) -> carry
        chunk_fn(carry, server_state, chunk_data, rows, chunk_ids,
                 chunk_weights, seed, offset, batch_idx=None, faults=None)
            -> carry
        finalize_fn(server_state, carry, ids, hook_state=None)
            -> RoundOutput

    The Simulator streams each chunk's client data onto the card
    (`simulation/ingest.py`) and passes rows = arange(chunk); the carry
    holds the partial sums (FULL mode: the update stack) and the cohort's
    state buffers. Health stats do not ride chunks (the cosine with the
    aggregate needs every update against the final aggregate, which
    chunking exists not to keep)."""
    if health_stats:
        raise ValueError(
            "health_stats cannot ride chunked rounds: cosine-to-aggregate "
            "needs the full update stack; run unchunked or disable "
            "train_args.extra.health_stats")
    parts = make_round_parts(alg, group_size, health_stats, **plugins)
    return parts.chunk_body, parts.finalize_body, parts.zero_carry
