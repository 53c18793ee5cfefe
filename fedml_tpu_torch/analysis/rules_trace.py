"""Trace-discipline rules: donation-after-use, retrace hazards, in-trace
purity. They share the helpers that spot a traced or compiled function.

`in-trace-purity` has a torch counterpart, checked beside the JAX
spellings: a function handed to `torch.func.vmap` / `grad` /
`grad_and_value` / `vjp` / `jvp` / `jacrev` / `functional_call` runs once
for a whole vmapped group (and a transform's body runs again under the
per-block recompute), so a host clock read or a draw from a global RNG
there is one value for every client, not one per client.
`donation-after-use` and `retrace-hazard` guard JAX constructs the port
does not have (buffer donation, compiled programs built in a loop); they
stay registered under their names and hold to the JAX fixtures, and find
nothing on the port's tree.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import Finding, LintContext, Rule, dotted_name

# Spellings that construct a compiled program. Matched on the dotted call
# chain's suffix so aliased module imports (`import jax.experimental.
# shard_map as shmap`) still register via the bare-name import map.
_JIT_SUFFIXES = ("jax.jit", "jax.pmap")
_BARE_JITTERS = {"jit", "pmap", "shard_map", "track_jit"}

# Tracing entry points that take a function OPERAND (not a decorator):
# dotted-suffix -> positional indices of the traced callables.
_TRACE_OPERANDS: dict[str, tuple[int, ...]] = {
    "jax.jit": (0,), "jax.pmap": (0,), "jax.vmap": (0,), "jax.grad": (0,),
    "jax.value_and_grad": (0,), "jax.checkpoint": (0,), "jax.remat": (0,),
    "lax.scan": (0,), "lax.map": (0,), "lax.fori_loop": (2,),
    "lax.while_loop": (0, 1), "lax.cond": (1, 2), "lax.associative_scan": (0,),
    "shard_map.shard_map": (0,), "shard_map": (0,), "track_jit": (0,),
    # torch.func transforms (called as torch.func.<name> or func.<name>)
    "func.vmap": (0,), "torch.vmap": (0,), "func.grad": (0,),
    "func.grad_and_value": (0,), "func.vjp": (0,), "func.jvp": (0,),
    "func.jacrev": (0,), "func.functional_call": (0,),
}

# the same transforms imported bare (`from torch.func import vmap`)
_TORCH_FUNC = {"vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
               "functional_call"}


def _torch_func_names(tree: ast.AST) -> set[str]:
    """Names this module imported from `torch.func`."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "torch.func":
            for alias in node.names:
                if alias.name in _TORCH_FUNC:
                    names.add(alias.asname or alias.name)
    return names


def _bare_jit_names(tree: ast.AST) -> set[str]:
    """Names this module imported that construct compiled programs
    (`from jax import jit`, `from jax.experimental.shard_map import
    shard_map`, `from ..utils.metrics import track_jit`)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name in _BARE_JITTERS:
                    names.add(alias.asname or alias.name)
    return names


def _is_jit_ctor(call: ast.Call, bare: set[str]) -> bool:
    d = dotted_name(call.func)
    if d is None:
        return False
    if any(d == s or d.endswith("." + s) for s in _JIT_SUFFIXES):
        return True
    return d in bare or (("." in d) and d.rsplit(".", 1)[1] in
                         {"shard_map"} and "shard_map" in d)


def _donate_argnums(call: ast.Call) -> Optional[tuple[int, ...]]:
    """Literal donate_argnums of a jit construction, or None."""
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                out = []
                for e in v.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value,
                                                                  int):
                        out.append(e.value)
                    else:
                        return None
                return tuple(out)
            return None
    return None


def _unwrap_track_jit(node: ast.AST) -> ast.AST:
    """`track_jit(jax.jit(f, donate_argnums=...), "name")` -> the inner
    jit call (the repo's standard instrumented-jit spelling)."""
    if isinstance(node, ast.Call):
        d = dotted_name(node.func)
        if d and (d == "track_jit" or d.endswith(".track_jit")) and node.args:
            return node.args[0]
    return node


def _walk_local(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function/class
    definitions (they are separate scopes with their own timing)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _var_key(node: ast.AST) -> Optional[str]:
    """A trackable donated-argument expression: a bare name (`carry`) or a
    self attribute (`self._carry`)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return "self." + node.attr
    return None


class DonationAfterUseRule(Rule):
    """donation-after-use: a value passed at a `donate_argnums` position is
    read after the call. Donation hands the buffer to XLA and invalidates
    the caller's reference; the convention is `carry = step(carry, ...)`.
    The port donates nothing, so on its tree the rule finds nothing; it is
    kept under the JAX name and held to the JAX fixtures.

    Scope (documented limits): tracks callables bound from
    `jax.jit(..., donate_argnums=<literal>)` — optionally wrapped in
    `track_jit(...)` — to a local name, a module-level name, or a `self.`
    attribute; flags lexically-later reads in the same function with no
    intervening rebind. Loop back-edges are not modeled."""

    name = "donation-after-use"
    summary = ("value read after being passed through a donate_argnums "
               "call site")

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for rel, f in ctx.files.items():
            yield from self._check_file(rel, f.tree)

    # -- per-file -----------------------------------------------------
    def _check_file(self, rel: str, tree: ast.AST) -> Iterable[Finding]:
        bare = _bare_jit_names(tree)
        # donating callables bound to self attributes (class-wide — the
        # `self._step_jit = jax.jit(..., donate_argnums=...)` idiom) or to
        # TRUE module-level names; function-local bindings are collected
        # per function in _check_function, so one function's `step` cannot
        # leak into another's scope
        self_map: dict[str, tuple[int, ...]] = {}
        global_map: dict[str, tuple[int, ...]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            val = _unwrap_track_jit(node.value)
            if not (isinstance(val, ast.Call) and _is_jit_ctor(val, bare)):
                continue
            nums = _donate_argnums(val)
            if nums is None:
                continue
            for tgt in node.targets:
                key = _var_key(tgt)
                if key and key.startswith("self."):
                    self_map[key[5:]] = nums
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if not isinstance(node, ast.Assign):
                continue
            val = _unwrap_track_jit(node.value)
            if isinstance(val, ast.Call) and _is_jit_ctor(val, bare):
                nums = _donate_argnums(val)
                if nums is not None:
                    for tgt in node.targets:
                        key = _var_key(tgt)
                        if key and not key.startswith("self."):
                            global_map[key] = nums
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            yield from self._check_function(rel, fn, bare, self_map,
                                            global_map)

    def _check_function(self, rel: str, fn: ast.AST, bare: set[str],
                        self_map: dict, global_map: dict
                        ) -> Iterable[Finding]:
        local_map: dict[str, tuple[int, ...]] = dict(global_map)
        loads: dict[str, list[ast.AST]] = {}
        binds: dict[str, list[int]] = {}

        for node in _walk_local(fn):
            if isinstance(node, ast.Assign):
                val = _unwrap_track_jit(node.value)
                if isinstance(val, ast.Call) and _is_jit_ctor(val, bare):
                    nums = _donate_argnums(val)
                    if nums is not None:
                        for tgt in node.targets:
                            key = _var_key(tgt)
                            if key and not key.startswith("self."):
                                local_map[key] = nums
            # record binds (any store position clears the use-after state)
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), (ast.Store, ast.Del)):
                key = _var_key(node)
                if key:
                    binds.setdefault(key, []).append(node.lineno)
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), ast.Load):
                key = _var_key(node)
                if key:
                    loads.setdefault(key, []).append(node)

        for node in _walk_local(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            nums: Optional[tuple[int, ...]] = None
            label = None
            if isinstance(callee, ast.Name) and callee.id in local_map:
                nums, label = local_map[callee.id], callee.id
            else:
                k = _var_key(callee)
                if k and k.startswith("self.") and k[5:] in self_map:
                    nums, label = self_map[k[5:]], k
            if nums is None:
                continue
            for i in nums:
                if i >= len(node.args):
                    continue
                vk = _var_key(node.args[i])
                if vk is None:
                    continue
                end = node.end_lineno or node.lineno
                for ld in loads.get(vk, []):
                    if ld.lineno <= end:
                        continue
                    if any(node.lineno <= b <= ld.lineno
                           for b in binds.get(vk, [])):
                        continue
                    yield Finding(
                        self.name, rel, ld.lineno, ld.col_offset,
                        f"`{vk}` was donated to `{label}` at line "
                        f"{node.lineno} (donate_argnums position {i}) and "
                        "is read here — the donated buffer is invalidated "
                        "by the call; rebind the result "
                        f"(`{vk} = {label}(...)`) or drop this read")
                    break  # one finding per (call, var) is enough


class RetraceHazardRule(Rule):
    """retrace-hazard: `jax.jit` / `jax.pmap` / `shard_map` / `track_jit`
    construction inside a loop (for/while/comprehension). Every
    construction starts a fresh compile cache, so a loop builds (and
    compiles) a new program per iteration. Hoist the construction out of
    the loop or cache it keyed on the traced signature. The port builds
    no compiled program, so on its tree the rule finds nothing; it is
    kept under the JAX name and held to the JAX fixtures."""

    name = "retrace-hazard"
    summary = "compiled-program construction inside a loop"

    _LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
              ast.DictComp, ast.GeneratorExp)

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for rel, f in ctx.files.items():
            bare = _bare_jit_names(f.tree)
            yield from self._visit(rel, f.tree, bare, 0)

    def _visit(self, rel: str, node: ast.AST, bare: set[str],
               depth: int) -> Iterable[Finding]:
        for child in ast.iter_child_nodes(node):
            d = depth + isinstance(child, self._LOOPS)
            if depth and isinstance(child, ast.Call) \
                    and _is_jit_ctor(child, bare):
                label = dotted_name(child.func) or "jit"
                yield Finding(
                    self.name, rel, child.lineno, child.col_offset,
                    f"`{label}(...)` constructed inside a loop — each "
                    "iteration compiles a fresh program (and races "
                    "concurrent builders); hoist the construction out of "
                    "the loop or cache it")
            yield from self._visit(rel, child, bare, d)


# in-trace purity ------------------------------------------------------
_NP_GLOBAL_STATE = {
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "ranf", "sample", "shuffle", "permutation", "choice", "uniform",
    "normal", "standard_normal", "binomial", "poisson", "beta", "gamma",
    "exponential", "get_state", "set_state",
}
_TIME_FNS = {"time", "perf_counter", "monotonic", "sleep", "process_time",
             "time_ns", "perf_counter_ns", "monotonic_ns"}


class InTracePurityRule(Rule):
    """in-trace-purity: `np.random` global-state calls, `time.*`, or host
    I/O (`open`) reached from a function that flows into `jit` / `scan` /
    `vmap` / `shard_map` / the control-flow combinators, or into a
    `torch.func` transform. Inside a trace these run once at trace time;
    inside a torch.func transform, once for a whole vmapped group. Thread
    explicit keys or generators, and measure time outside.

    Roots are found per file: function operands of the tracing entry
    points plus `@jax.jit` / `@partial(jax.jit, ...)` decorated defs;
    tracedness propagates through same-file calls."""

    name = "in-trace-purity"
    summary = "host side effects reachable from traced code"

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for rel, f in ctx.files.items():
            yield from self._check_file(rel, f.tree)

    def _check_file(self, rel: str, tree: ast.AST) -> Iterable[Finding]:
        defs: dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node

        roots: set[str] = set()
        bare_func = _torch_func_names(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                if d is None:
                    continue
                if d in bare_func and node.args \
                        and isinstance(node.args[0], ast.Name):
                    roots.add(node.args[0].id)
                    continue
                for suffix, positions in _TRACE_OPERANDS.items():
                    if d == suffix or d.endswith("." + suffix):
                        for i in positions:
                            if i < len(node.args) and isinstance(
                                    node.args[i], ast.Name):
                                roots.add(node.args[i].id)
                        break
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    dd = dotted_name(dec)
                    inner = dec.args[0] if (
                        isinstance(dec, ast.Call) and dec.args) else None
                    if dd in ("jax.jit", "jit"):
                        roots.add(node.name)
                    elif isinstance(dec, ast.Call) and (
                            dotted_name(dec.func) or "").endswith("partial") \
                            and inner is not None \
                            and dotted_name(inner) in ("jax.jit", "jit"):
                        roots.add(node.name)

        # propagate tracedness through the same-file call graph
        traced = {n for n in roots if n in defs}
        frontier = list(traced)
        while frontier:
            fn = defs[frontier.pop()]
            for node in _walk_local(fn):
                if isinstance(node, ast.Call) and isinstance(node.func,
                                                             ast.Name):
                    callee = node.func.id
                    if callee in defs and callee not in traced:
                        traced.add(callee)
                        frontier.append(callee)

        for name in sorted(traced):
            fn = defs[name]
            for node in _walk_local(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted_name(node.func)
                if d is None:
                    continue
                parts = d.split(".")
                if len(parts) >= 3 and parts[-2] == "random" \
                        and parts[0] in ("np", "numpy") \
                        and parts[-1] in _NP_GLOBAL_STATE:
                    yield Finding(
                        self.name, rel, node.lineno, node.col_offset,
                        f"`{d}(...)` inside `{name}`, which is traced into "
                        "a compiled program — global numpy RNG state runs "
                        "at trace time and clobbers other threads; thread "
                        "an explicit key (jax.random) or a local "
                        "RandomState instead")
                elif len(parts) == 2 and parts[0] == "time" \
                        and parts[1] in _TIME_FNS:
                    yield Finding(
                        self.name, rel, node.lineno, node.col_offset,
                        f"`{d}()` inside `{name}`, which is traced into a "
                        "compiled program — the clock is read ONCE at "
                        "trace time and baked into the executable; measure "
                        "around the dispatch on the host instead")
                elif d == "open":
                    yield Finding(
                        self.name, rel, node.lineno, node.col_offset,
                        f"host I/O `open(...)` inside `{name}`, which is "
                        "traced into a compiled program — it runs at trace "
                        "time, not per step; do I/O outside the program "
                        "and pass arrays in")
