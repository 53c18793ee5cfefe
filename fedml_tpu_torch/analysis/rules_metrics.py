"""metric-registry: metric-name consistency across emit and consume sites.

The observability contract is stringly typed: `utils/metrics.py`
instruments by dotted name (the `fed.*`, `serving.*`, `comm.*` (with
`comm.link.*`), `xla.*`, `soak.*`, `loadgen.*`, `slo.*`, `events.*` and
`obs.*` families), `utils/prometheus.py` sanitizes those to exposition
names (`fed_rounds_total`), and the `top` verb and the README document
them back to operators. Nothing ties the three together: a typo'd emit
or a renamed metric leaves `top` reading a key nobody writes. This rule:

  1. collects every metric-name literal at an emit site (inc / observe /
     set_gauge / counter / gauge / histogram / timer /
     `AtomicCounter(gauge=...)`; f-strings register their literal prefix),
  2. flags emit-site near-miss typos — a name emitted at exactly one
     site, consumed nowhere, at edit distance 1 of an established name
     (consumed somewhere, or emitted at 2+ sites),
  3. flags names consumed by `top` (`_top_frame`'s sanitized exposition
     names), diagnosis probes (raw dotted names in __main__.py), or the
     documents (backticked `fed.* / serving.* / comm.*` tokens; `*` and
     `<id>` tails make a prefix claim) that no emit site produces.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Iterable, Optional

from .core import (
    Finding,
    LintContext,
    Rule,
    SourceFile,
    const_str,
    dotted_name,
    edit_distance,
)

_FAMILIES = ("fed", "serving", "comm", "xla", "soak", "loadgen", "slo",
             "events", "obs")
_RAW_RE = re.compile(
    r"^(?:fed|serving|comm|xla|soak|loadgen|slo|events|obs)\.[a-z0-9_.]*$")
_SAN_RE = re.compile(
    r"^(?:fed|serving|comm|xla|soak|loadgen|slo|events|obs)_[a-z0-9_]+$")
_DOC_RE = re.compile(
    r"`((?:fed|serving|comm|xla|soak|loadgen|slo|events|obs)\.[^`\s]+)`")
_INVALID = re.compile(r"[^a-zA-Z0-9_:]")

# method name -> instrument kind
_EMIT_METHODS = {"inc": "counter", "counter": "counter",
                 "observe": "histogram", "histogram": "histogram",
                 "timer": "histogram",
                 "set_gauge": "gauge", "gauge": "gauge"}


def _sanitize(name: str) -> str:
    s = _INVALID.sub("_", name)
    return ("_" + s) if s and s[0].isdigit() else (s or "_")


@dataclass
class Emit:
    name: str          # raw dotted name, or literal prefix for f-strings
    kind: str          # counter | gauge | histogram
    prefix: bool       # True when from an f-string (open-ended tail)
    path: str
    line: int
    col: int

    def sanitized(self) -> set[str]:
        """Exposition spellings this emit produces (counters exist both
        raw and with the renderer's `_total` suffix)."""
        s = _sanitize(self.name)
        out = {s}
        if self.kind == "counter" and not self.prefix \
                and not s.endswith("_total"):
            out.add(s + "_total")
        return out


class MetricRegistryRule(Rule):
    name = "metric-registry"
    summary = "metric-name typos and consumed-but-never-emitted names"

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        emits = self._collect_emits(ctx)
        if not emits:
            return  # no instrumented code in this scan
        yield from self._check_typos(ctx, emits)
        yield from self._check_consumers(ctx, emits)

    # ------------------------------------------------------- emit sites
    def _metric_aliases(self, tree: ast.AST) -> tuple[set[str], set[str]]:
        """(receiver names bound to the metrics module, bare emit helpers
        imported from it) for one file."""
        receivers = {"registry"}
        bare: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[-1] == "metrics":
                        receivers.add(a.asname or "metrics")
            elif isinstance(node, ast.ImportFrom):
                mod = (node.module or "").split(".")[-1]
                for a in node.names:
                    if a.name == "metrics":
                        receivers.add(a.asname or "metrics")
                    elif mod == "metrics" and a.name in _EMIT_METHODS:
                        bare.add(a.asname or a.name)
                    elif mod == "metrics" and a.name == "registry":
                        receivers.add(a.asname or "registry")
        return receivers, bare

    def _collect_emits(self, ctx: LintContext) -> list[Emit]:
        emits: list[Emit] = []
        for rel, f in ctx.files.items():
            receivers, bare = self._metric_aliases(f.tree)
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                kind = None
                arg: Optional[ast.AST] = None
                d = dotted_name(node.func)
                if d is not None:
                    parts = d.split(".")
                    if parts[-1] in _EMIT_METHODS and node.args and (
                            (len(parts) == 1 and parts[0] in bare)
                            or (len(parts) > 1
                                and parts[-2] in receivers)):
                        kind = _EMIT_METHODS[parts[-1]]
                        arg = node.args[0]
                    elif parts[-1] == "span" and len(parts) > 1 \
                            and node.args:
                        # recorder.span("name") — a Chrome-trace span, not
                        # a /metrics series; collected so README span
                        # claims resolve, excluded from scrape-surface
                        # matching and typo checks
                        kind, arg = "span", node.args[0]
                    elif parts[-1] == "AtomicCounter":
                        for kw in node.keywords:
                            if kw.arg == "gauge":
                                kind, arg = "gauge", kw.value
                if kind is None or arg is None:
                    continue
                self._collect_name(emits, arg, kind, rel)
        return emits

    def _collect_name(self, emits: list[Emit], arg: ast.AST, kind: str,
                      rel: str) -> None:
        if isinstance(arg, ast.IfExp):
            # `"a" if cond else "b"` emits either branch
            self._collect_name(emits, arg.body, kind, rel)
            self._collect_name(emits, arg.orelse, kind, rel)
            return
        s = const_str(arg)
        if s is not None:
            if _RAW_RE.match(s):
                emits.append(Emit(s, kind, False, rel,
                                  arg.lineno, arg.col_offset))
        elif isinstance(arg, ast.JoinedStr) and arg.values:
            head = const_str(arg.values[0])
            if head and _RAW_RE.match(head):
                emits.append(Emit(head, kind, True, rel,
                                  arg.lineno, arg.col_offset))

    # ------------------------------------------------------------ typos
    def _check_typos(self, ctx: LintContext,
                     emits: list[Emit]) -> Iterable[Finding]:
        consumed = self._consumed_names(ctx)
        exact = [e for e in emits if not e.prefix and e.kind != "span"]
        by_name: dict[str, list[Emit]] = {}
        for e in exact:
            by_name.setdefault(e.name, []).append(e)

        def is_consumed(e: Emit) -> bool:
            return bool(e.sanitized() & consumed or e.name in consumed)

        for name, sites in sorted(by_name.items()):
            if len(sites) != 1 or is_consumed(sites[0]):
                continue
            for other, osites in by_name.items():
                if other == name:
                    continue
                established = len(osites) >= 2 or is_consumed(osites[0])
                if established and edit_distance(name, other, 1) == 1:
                    e = sites[0]
                    yield Finding(
                        self.name, e.path, e.line, e.col,
                        f"metric `{name}` is emitted only here, consumed "
                        f"nowhere, and is one edit from the established "
                        f"`{other}` — probable typo (the two series will "
                        "silently split)")
                    break

    # -------------------------------------------------------- consumers
    def _consumed_names(self, ctx: LintContext) -> set[str]:
        """Every exact name any consumer surface reads (sanitized +
        raw spaces mixed; used for 'is this emit consumed' checks)."""
        names: set[str] = set()
        for exact, _prefix, _surface, _site in self._consumer_sites(ctx):
            names.add(exact)
        return names

    def _consumer_sites(self, ctx: LintContext):
        """Yield (name, is_prefix, surface, (path, line, col)) consumer
        claims. Surfaces: "top" (_top_frame's sanitized exposition names),
        "raw" (dotted snapshot reads anywhere in __main__.py — diagnosis
        probes), "doc" (backticked README tokens — the only surface where
        Chrome-trace span names legitimately appear)."""
        main = ctx.get("__main__.py")
        if main is not None:
            prefix_lits = self._prefix_literals(main.tree)
            top = next((n for n in ast.walk(main.tree)
                        if isinstance(n, ast.FunctionDef)
                        and n.name == "_top_frame"), None)
            if top is not None:
                for node in ast.walk(top):
                    s = const_str(node)
                    if s and _SAN_RE.match(s):
                        yield (s, s in prefix_lits, "top",
                               (main.path, node.lineno, node.col_offset))
            for node in ast.walk(main.tree):
                s = const_str(node)
                if s and _RAW_RE.match(s) and "." in s[1:]:
                    yield (s, s.endswith(".") or s in prefix_lits, "raw",
                           (main.path, node.lineno, node.col_offset))
        for label, text in ctx.extra_docs.items():
            for i, line in enumerate(text.splitlines(), 1):
                for m in _DOC_RE.finditer(line):
                    tok = m.group(1)
                    core = re.match(r"[a-z0-9_.]*", tok).group(0)
                    if len(core) < len(tok) or core.endswith("."):
                        # `fed.health.*`, `fed.participation.c<id>` —
                        # a prefix claim
                        yield (core.rstrip("."), True, "doc",
                               (label, i, m.start()))
                    elif _RAW_RE.match(core):
                        yield (core, False, "doc", (label, i, m.start()))

    @staticmethod
    def _prefix_literals(tree: ast.AST) -> set[str]:
        """Literals the file only ever uses as prefixes: args of
        `.startswith(...)` and the `k[len("prefix"):]` slicing idiom."""
        out: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "startswith" and node.args:
                    s = const_str(node.args[0])
                    if s:
                        out.add(s)
                elif isinstance(node.func, ast.Name) \
                        and node.func.id == "len" and node.args:
                    s = const_str(node.args[0])
                    if s:
                        out.add(s)
        return out

    def _check_consumers(self, ctx: LintContext,
                         emits: list[Emit]) -> Iterable[Finding]:
        # spans never reach the /metrics scrape surface: they satisfy doc
        # claims (README names trace spans) but not `top`/snapshot reads
        scrape = [e for e in emits if e.kind != "span"]
        exact_raw = {e.name for e in scrape if not e.prefix}
        prefix_raw = [e.name for e in scrape if e.prefix]
        exact_san: set[str] = set()
        for e in scrape:
            if not e.prefix:
                exact_san |= e.sanitized()
        prefix_san = [_sanitize(p) for p in prefix_raw]
        span_exact = {e.name for e in emits
                      if e.kind == "span" and not e.prefix}
        span_prefix = [e.name for e in emits if e.kind == "span" and e.prefix]

        seen: set[tuple[str, bool]] = set()
        for name, is_prefix, surface, (path, line, col) \
                in self._consumer_sites(ctx):
            if (name, is_prefix) in seen:
                continue
            seen.add((name, is_prefix))
            if is_prefix:
                ok = (any(s.startswith(name) for s in exact_san | exact_raw)
                      or any(p.startswith(name) or name.startswith(p)
                             for p in prefix_san + prefix_raw))
                if surface == "doc" and not ok:
                    ok = (any(s.startswith(name) for s in span_exact)
                          or any(p.startswith(name) or name.startswith(p)
                                 for p in span_prefix))
            else:
                ok = (name in exact_raw or name in exact_san
                      or any(name.startswith(p)
                             for p in prefix_san + prefix_raw))
                if surface == "doc" and not ok:
                    ok = (name in span_exact
                          or any(name.startswith(p) for p in span_prefix))
            if not ok:
                yield Finding(
                    self.name, path, line, col,
                    f"metric `{name}` is consumed here but no emit site "
                    "produces it — a dead read (renamed or typo'd emit, "
                    "or stale documentation)")
