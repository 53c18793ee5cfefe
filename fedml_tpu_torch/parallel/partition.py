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
`lora_rules`, the KV-cache specs) and `shard_params` belong to tensor
parallelism (ROADMAP 'Port queue' entry 6b) and come with it; until then
`TABLES` is empty and `rules_for` names no table.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

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
        hits = [(pat, spec) for pat, rx, spec in compiled
                if rx.search(name) is not None]
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
        return spec

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
        src = next((pat for pat, rx, s in compiled
                    if rx.search(name) is not None
                    and tuple(s) == tuple(spec)), None)
        shape = tuple(getattr(leaf, "shape", ()))
        lines.append(f"{name:<44} {str(shape):<20} -> {str(spec):<24} "
                     f"[{src if src is not None else '<unmatched/scalar>'}]")
    return "\n".join(lines)


def fed_data_rules(axis: str = "clients") -> Rules:
    """Stacked federated client data ({"x","y","mask"}: [N, S, ...]): the
    leading client axis over the federated axis."""
    return ((r"^(x|y|mask)$", P(axis)),)


# the named model-parallel tables arrive with tensor parallelism (entry 6b)
TABLES: dict = {}


def rules_for(name: str, axis: str = "mp") -> Rules:
    """A named rule table."""
    try:
        return TABLES[name](axis)
    except KeyError:
        raise PartitionRuleError(
            f"unknown partition rule table {name!r}; "
            f"valid: {sorted(TABLES)}") from None


def resolve(rules, params: Pytree, *, axis: str = "mp",
            on_unmatched: str = ERROR) -> Pytree:
    """`match_partition_rules` taking a table name or a rule sequence."""
    if isinstance(rules, str):
        rules = rules_for(rules, axis)
    return match_partition_rules(rules, params, on_unmatched=on_unmatched)
