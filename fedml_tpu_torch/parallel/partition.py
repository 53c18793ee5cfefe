"""The partition-rule registry (port of `fedml_tpu/parallel/partition.py`:
the registry and the federated data rules).

A rule table is an ordered sequence of `(regex, PartitionSpec)` pairs;
`match_partition_rules(rules, tree)` resolves every leaf of a tree (nested
dicts, lists and tuples; dict keys in sorted order, as JAX flattens them)
to a spec by `re.search` over its '/'-joined path. The policies are JAX's:
a leaf matching two rules with different specs is an
`AmbiguousRuleError`; a leaf matching none is an `UnmatchedParamError`
unless `on_unmatched="replicated"`; scalars and size-1 leaves resolve to
`P()` without consulting the table; a spec with more axes than its leaf
has dims, a broken regex, and one pattern listed twice with different
specs are refused at resolution. Errors and `explain`'s table are JAX's
word for word.

`PartitionSpec` (alias `P`) is a tuple of axis names (or None) that
prints as JAX's does. The port's mesh code reads a spec as the leading
axes a leaf splits over, in contiguous blocks by mesh coordinate
(`parallel/round.shard_fed_data`). `fed_data_rules` places the stacked
client data's {"x", "y", "mask"} on the `clients` axis.

The model-parallel tables (`transformer_lm_rules`, `mlp_cnn_rules`,
`lora_rules`, `TABLES`, `table_for_model`) and the KV-cache specs are
JAX's, in JAX's spelling only. A port state-dict name is mapped to flax's
spelling before it is matched (`flax_name`: '.' -> '/', `blocks.{i}` ->
`block_{i}`, so `blocks.0.wq.kernel.q` matches as `block_0/wq/kernel/q`),
so a flax-shaped tree and the port's state dict resolve through the same
patterns, and `explain` prints them word for word. The one layout that
differs is the conv kernel: the port's is OIHW where flax's is HWIO, so a
port conv kernel takes the flax spec with its dims permuted
(`P(None, None, None, "mp")` -> `P("mp")`, its output channels).

`shard_params` is the port's `device_put`: this rank's local block of
each leaf, cut on every dim its spec names by the rank's coordinate on
that mesh axis (tensors or numpy arrays; a dict of {"q", "s"} stays a
dict).
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np

Pytree = Any
Rules = Sequence[tuple]

ERROR = "error"
REPLICATED = "replicated"


class PartitionSpec(tuple):
    """Axis names (or None) per leading dim; prints as JAX's spec."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


class PartitionRuleError(ValueError):
    """A rule table failed to load or resolve against a tree."""


class AmbiguousRuleError(PartitionRuleError):
    """One leaf matched two rules with different specs."""


class UnmatchedParamError(PartitionRuleError):
    """A leaf matched no rule under the default `on_unmatched="error"`."""


def _flatten(tree, path=()) -> list:
    """[(path, leaf)] in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(tree, Mapping):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def path_name(path) -> str:
    """'/'-joined leaf path, the name the rule regexes match."""
    return "/".join(str(p) for p in path)


_PORT_BLOCK = re.compile(r"(^|/)blocks/(\d+)(?=/)")


def flax_name(name: str) -> str:
    """A port state-dict name in flax's spelling, which the tables match
    ('.' -> '/', `blocks/{i}` -> `block_{i}`); a flax name, which has no
    '.', comes back as it is."""
    if "." not in name:
        return name
    return _PORT_BLOCK.sub(r"\1block_\2", name.replace(".", "/"))


def _layout(name: str, shape: tuple, spec) -> "PartitionSpec":
    """`spec`, resolved for the flax layout, as the port's leaf `name`
    lays it out: a port conv kernel is OIHW where flax's is HWIO."""
    if "." not in name or len(shape) != 4 or len(spec) != 4:
        return spec
    oihw = [spec[3], spec[2], spec[0], spec[1]]
    while oihw and oihw[-1] is None:
        oihw.pop()
    return P(*oihw)


def _compile(rules: Rules) -> list:
    seen: dict = {}
    out = []
    for pattern, spec in rules:
        try:
            rx = re.compile(pattern)
        except re.error as e:
            raise PartitionRuleError(
                f"partition rule {pattern!r} is not a valid regex: {e}"
            ) from None
        if pattern in seen and seen[pattern] != tuple(spec):
            raise AmbiguousRuleError(
                f"rule table lists pattern {pattern!r} twice with "
                f"different specs ({seen[pattern]} vs {tuple(spec)})")
        seen[pattern] = tuple(spec)
        out.append((pattern, rx, spec))
    return out


def match_partition_rules(rules: Rules, params: Pytree, *,
                          on_unmatched: str = ERROR) -> Pytree:
    """A same-structure tree of PartitionSpecs (module docstring)."""
    if on_unmatched not in (ERROR, REPLICATED):
        raise ValueError(
            f"on_unmatched must be {ERROR!r} or {REPLICATED!r}; "
            f"got {on_unmatched!r}")
    compiled = _compile(rules)

    def spec_for(path, leaf):
        name = path_name(path)
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        fname = flax_name(name)
        hits = [(pat, spec) for pat, rx, spec in compiled
                if rx.search(fname) is not None]
        distinct = {tuple(spec) for _pat, spec in hits}
        if len(distinct) > 1:
            detail = "; ".join(f"{pat!r} -> {spec}" for pat, spec in hits)
            raise AmbiguousRuleError(
                f"param {name!r} matches rules with different specs: "
                f"{detail}")
        if not hits:
            if on_unmatched == REPLICATED:
                return P()
            raise UnmatchedParamError(
                f"no partition rule matches param {name!r} (shape "
                f"{shape}); add a rule or pass "
                f"on_unmatched='replicated' to replicate unmatched params")
        spec = hits[0][1]
        if len(spec) > len(shape):
            raise PartitionRuleError(
                f"rule {hits[0][0]!r} assigns {len(spec)}-axis spec "
                f"{spec} to param {name!r} of rank {len(shape)}")
        return _layout(name, shape, spec)

    specs = [spec_for(p, leaf) for p, leaf in _flatten(params)]
    return _unflatten(params, iter(specs))


def explain(rules: Rules, params: Pytree, *,
            on_unmatched: str = ERROR) -> str:
    """One line per leaf: its path, shape, resolved spec and the rule that
    produced it."""
    rules = rules_for(rules) if isinstance(rules, str) else rules
    compiled = _compile(rules)
    specs = match_partition_rules(rules, params, on_unmatched=on_unmatched)
    flat_s = [s for _p, s in _flatten(specs)]
    lines = []
    for (path, leaf), spec in zip(_flatten(params), flat_s):
        name = path_name(path)
        shape = tuple(getattr(leaf, "shape", ()))
        src = next((pat for pat, rx, s in compiled
                    if rx.search(flax_name(name)) is not None
                    and tuple(_layout(name, shape, s)) == tuple(spec)),
                   None)
        lines.append(f"{name:<44} {str(shape):<20} -> {str(spec):<24} "
                     f"[{src if src is not None else '<unmatched/scalar>'}]")
    return "\n".join(lines)


def fed_data_rules(axis: str = "clients") -> Rules:
    """Stacked federated client data ({"x","y","mask"}: [N, S, ...]): the
    leading client axis over the federated axis."""
    return ((r"^(x|y|mask)$", P(axis)),)


# --------------------------------------------------------------- rule tables
_COL = r"wq|wk|wv|w_gate|w_up"   # Megatron column split: shard OUTPUT features
_ROW = r"wo|w_down"              # Megatron row split:    shard INPUT features


def transformer_lm_rules(axis: str = "mp") -> Rules:
    """The TransformerLM table, Megatron column-then-row over `axis`
    (JAX's rules): column kernels [din, dout] split dout, row kernels
    split din, an int8 `q` like its kernel, its per-dout scales `s` with
    a column kernel and replicated for a row kernel, embed [V, D] on D,
    lm_head [D, V] on V (their scales replicated), norms replicated. The
    stacked flax layout keeps its leading [L] axis replicated. LoRA
    adapters resolve through `lora_rules`."""
    a = axis
    return (
        # unrolled blocks (the port's `blocks.{i}`): kernel/q [din, dout],
        # scales s [1, dout]
        (rf"(^|/)block_\d+/({_COL})/kernel(/(q|s))?$", P(None, a)),
        (rf"(^|/)block_\d+/({_ROW})/kernel(/q)?$", P(a, None)),
        (rf"(^|/)block_\d+/({_ROW})/kernel/s$", P()),
        # flax scan-layers stacked blocks: [L, din, dout], scales [L, 1, dout]
        (rf"(^|/)blocks/({_COL})/kernel(/(q|s))?$", P(None, None, a)),
        (rf"(^|/)blocks/({_ROW})/kernel(/q)?$", P(None, a, None)),
        (rf"(^|/)blocks/({_ROW})/kernel/s$", P()),
        (r"(^|/)embed/embedding(/q)?$", P(None, a)),
        (r"(^|/)embed/embedding/s$", P()),
        (r"(^|/)lm_head/kernel(/q)?$", P(None, a)),
        (r"(^|/)lm_head/kernel/s$", P()),
        (r"(^|/)RMSNorm_\d+/scale$", P()),
        (r"(^|/)final_norm/scale$", P()),
    )


def mlp_cnn_rules(axis: str = "mp") -> Rules:
    """MLP / CNN models: Dense kernels [din, dout] column-split on dout,
    conv kernels on their output channels (flax HWIO: the last dim; a
    port conv kernel, OIHW, takes it on dim 0 through `_layout`), biases
    and norm scales replicated, embeddings on their features. Anything
    else falls to the unmatched policy."""
    a = axis
    return (
        (r"(^|/)Dense_\d+/kernel$", P(None, a)),
        (r"(^|/)Conv_\d+/kernel$", P(None, None, None, a)),
        (r"(/|^)(bias|scale)$", P()),
        (r"embedding$", P(None, a)),
    )


def lora_rules(axis: str = "mp") -> Rules:
    """LoRA adapter trees: replicated (the federated round payload; only
    the frozen base is split). `axis` is unused."""
    return ((r".", P()),)


def kv_cache_spec(axis: str = "mp"):
    """The contiguous KV cache [L, S, max_len, H, Dh]: heads over `axis`
    (each rank holds the K/V of its own heads)."""
    return P(None, None, None, axis, None)


def paged_kv_cache_spec(axis: str = "mp"):
    """The paged KV pool [L, n_pages, page_size, H, Dh]: heads over
    `axis`, page axes replicated; the page table rides replicated."""
    return P(None, None, None, axis, None)


def paged_kv_scale_spec(axis: str = "mp"):
    """The int8 pool's per-(page, head) scales [L, n_pages, H]: heads over
    `axis` like the pool rows they dequantise."""
    return P(None, None, axis)


TABLES = {
    "transformer_lm": transformer_lm_rules,
    "mlp_cnn": mlp_cnn_rules,
    "lora": lora_rules,
}


def rules_for(name: str, axis: str = "mp") -> Rules:
    """A named rule table (the `device_args.partition_rules` values
    config.py validates)."""
    try:
        return TABLES[name](axis)
    except KeyError:
        raise PartitionRuleError(
            f"unknown partition rule table {name!r}; "
            f"valid: {sorted(TABLES)}") from None


def table_for_model(model) -> str:
    """The default table of a model: TransformerLM's Megatron table,
    everything else the Dense/Conv table."""
    return ("transformer_lm"
            if type(model).__name__ == "TransformerLM" else "mlp_cnn")


def resolve(rules, params: Pytree, *, axis: str = "mp",
            on_unmatched: str = ERROR) -> Pytree:
    """`match_partition_rules` taking a table name or a rule sequence: the
    one entry point train and serve both call."""
    if isinstance(rules, str):
        rules = rules_for(rules, axis)
    return match_partition_rules(rules, params, on_unmatched=on_unmatched)


def local_block(leaf, spec, mesh):
    """`leaf`'s block on this rank: each dim its spec names an axis of is
    cut into that axis's size contiguous blocks and the rank keeps the
    one at its coordinate (a torch tensor comes back contiguous, a numpy
    array as a copy)."""
    from .mesh import axis_index, axis_size

    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if not isinstance(ax, str):
            raise PartitionRuleError(
                f"spec {spec} splits one dim over several axes; the port "
                "splits a dim over one mesh axis")
        n, k = axis_size(mesh, ax), axis_index(mesh, ax)
        size = leaf.shape[dim]
        if size % n:
            raise PartitionRuleError(
                f"dim {dim} of a {tuple(leaf.shape)} leaf does not split "
                f"over the {n} ranks of mesh axis {ax!r}")
        b = size // n
        if isinstance(leaf, np.ndarray):
            leaf = np.take(leaf, np.arange(k * b, (k + 1) * b), axis=dim)
        else:
            leaf = leaf.narrow(dim, k * b, b)
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf)
    return leaf.contiguous() if any(a is not None for a in spec) else leaf


def shard_params(params: Pytree, mesh, rules="transformer_lm", *,
                 axis: str = "mp", on_unmatched: str = ERROR,
                 specs: Optional[Pytree] = None) -> Pytree:
    """This rank's shard of `params` under registry-resolved specs over
    `mesh` (`local_block` of each leaf; a replicated leaf is the leaf
    itself). Pass `specs` to reuse an already-resolved tree."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        raise PartitionRuleError(
            f"mesh axes {tuple(names)} have no {axis!r} axis; partition "
            f"rules shard over {axis!r} — add it to the mesh shape")
    if specs is None:
        specs = resolve(rules, params, axis=axis, on_unmatched=on_unmatched)
    flat_s = iter([s for _p, s in _flatten(specs)])
    leaves = [local_block(leaf, next(flat_s), mesh)
              for _p, leaf in _flatten(params)]
    return _unflatten(params, iter(leaves))


def unshard_params(shard: Pytree, mesh, specs: Pytree) -> Pytree:
    """The whole tree back from every rank's `shard_params` shard: each
    leaf all-gathered over the axes its spec names (collective over those
    axes; every rank gets the whole tree)."""
    from .mesh import all_gather_dim

    flat_s = iter([s for _p, s in _flatten(specs)])
    leaves = []
    for _p, leaf in _flatten(shard):
        for dim, ax in enumerate(next(flat_s)):
            if ax is not None:
                leaf = all_gather_dim(leaf, mesh, ax, dim)
        leaves.append(leaf)
    return _unflatten(shard, iter(leaves))
