"""graftlint rule engine: file loading, suppressions, reporters.

Design notes
------------
- A `Rule` is a callable object with a `name` (the suppression token) and
  a `check(ctx)` returning findings over the WHOLE scanned tree. Per-file
  rules simply iterate `ctx.files`; cross-file rules (knob drift, metric
  registry) correlate several files and only activate when their anchor
  files are present in the scan — so pointing the linter at a fixture
  subtree exercises exactly the rules the fixture stages.
- Suppressions are per-line: `# graftlint: disable=rule-a,rule-b` on the
  FLAGGED line. They are honored after collection, so reporters can also
  say how many findings a scan suppressed.
- Everything here is stdlib-only (ast/re/json): the linter runs in
  environments without torch (a build hook, external CI).
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([a-zA-Z0-9_,\- ]+)")

# directories never scanned (caches, fixtures staged under the package)
_SKIP_DIRS = {"__pycache__", ".git", "lint_fixtures"}


@dataclass(frozen=True)
class Finding:
    """One lint finding. `path` is relative to the scan root."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclass
class SourceFile:
    path: str                 # scan-root-relative, '/'-separated
    abspath: str
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    def suppressed_rules(self, line: int) -> set[str]:
        """Rules disabled on `line` (1-indexed) by a graftlint comment."""
        if 1 <= line <= len(self.lines):
            m = _SUPPRESS_RE.search(self.lines[line - 1])
            if m:
                return {t.strip() for t in m.group(1).split(",") if t.strip()}
        return set()


class LintContext:
    """Parsed view of the scanned tree, shared by every rule."""

    def __init__(self, root: str, files: dict[str, SourceFile],
                 extra_docs: Optional[dict[str, str]] = None):
        self.root = root
        self.files = files
        # non-python consumer surfaces (README.md) for the metric rule:
        # {label: text}
        self.extra_docs = extra_docs or {}

    def get(self, suffix: str) -> Optional[SourceFile]:
        """The unique scanned file whose relpath matches `suffix` exactly
        or ends with '/<suffix>' — rules anchor on files like
        'serving/knobs.py' without caring where the scan root sits."""
        hits = [f for p, f in self.files.items()
                if p == suffix or p.endswith("/" + suffix)]
        return hits[0] if len(hits) == 1 else None


def _iter_py_files(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def load_tree(paths: Iterable[str],
              extra_docs: Optional[dict[str, str]] = None) -> LintContext:
    """Parse every .py under `paths` into a LintContext. Syntax errors are
    surfaced as parse-error findings by `run_lint`, not exceptions — a
    half-written file must not take the whole lint plane down."""
    paths = [os.path.abspath(p) for p in paths]
    for p in paths:
        if not os.path.exists(p):
            # a typo'd path must be a loud usage error, not a vacuous
            # "0 findings over 0 files" green in somebody's CI
            raise OSError(f"lint path does not exist: {p}")
    root = paths[0] if len(paths) == 1 else (
        os.path.commonpath(paths) if paths else os.getcwd())
    if os.path.isfile(root):
        root = os.path.dirname(root)
    files: dict[str, SourceFile] = {}
    for p in paths:
        for abspath in _iter_py_files(p):
            rel = os.path.relpath(abspath, root).replace(os.sep, "/")
            if rel in files:
                continue
            with open(abspath, encoding="utf-8") as f:
                src = f.read()
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError as e:
                tree = ast.Module(body=[], type_ignores=[])
                files[rel] = SourceFile(rel, abspath, src, tree,
                                        src.splitlines())
                files[rel]._syntax_error = e  # type: ignore[attr-defined]
                continue
            files[rel] = SourceFile(rel, abspath, src, tree,
                                    src.splitlines())
    return LintContext(root, files, extra_docs)


class Rule:
    """Base class: subclasses set `name`/`summary` and implement
    `check(ctx) -> Iterable[Finding]`."""

    name: str = "rule"
    summary: str = ""

    def check(self, ctx: LintContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


def all_rules() -> list[Rule]:
    """The registered rule set, in catalog order."""
    from .rules_knobs import KnobDriftRule
    from .rules_locks import LockDisciplineRule
    from .rules_metrics import MetricRegistryRule
    from .rules_trace import (
        DonationAfterUseRule,
        InTracePurityRule,
        RetraceHazardRule,
    )

    return [DonationAfterUseRule(), RetraceHazardRule(), KnobDriftRule(),
            MetricRegistryRule(), LockDisciplineRule(),
            InTracePurityRule()]


def run_lint(paths: Optional[Iterable[str]] = None,
             rules: Optional[Iterable[str]] = None,
             extra_docs: Optional[dict[str, str]] = None,
             ) -> tuple[list[Finding], dict]:
    """Lint `paths` (default: the fedml_tpu_torch package tree) with the named
    `rules` (default: all). Returns (findings, stats) where stats records
    scanned-file and suppression counts. Findings come back sorted by
    (path, line, rule) so reporters and golden tests are deterministic."""
    if paths is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [pkg]
        if extra_docs is None:
            extra_docs = _default_docs(pkg)
    ctx = load_tree(paths, extra_docs)
    selected = all_rules()
    if rules is not None:
        wanted = set(rules)
        known = {r.name for r in selected}
        unknown = wanted - known
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"available: {sorted(known)}")
        selected = [r for r in selected if r.name in wanted]

    findings: list[Finding] = []
    for rel, f in ctx.files.items():
        err = getattr(f, "_syntax_error", None)
        if err is not None:
            findings.append(Finding(
                "parse-error", rel, err.lineno or 1, err.offset or 0,
                f"file does not parse: {err.msg}"))
    for rule in selected:
        findings.extend(rule.check(ctx))

    kept: list[Finding] = []
    suppressed = 0
    for fd in findings:
        src = ctx.files.get(fd.path)
        if src is not None and fd.rule in src.suppressed_rules(fd.line):
            suppressed += 1
            continue
        kept.append(fd)
    kept.sort(key=lambda fd: (fd.path, fd.line, fd.rule, fd.col))
    stats = {"files": len(ctx.files), "suppressed": suppressed,
             "rules": [r.name for r in selected]}
    return kept, stats


# the repository README's section on the port: the metric rule's document
# surface (the rest of the README documents the JAX package's names)
PORT_SECTION = "## PyTorch/CUDA port"


def _default_docs(pkg_dir: str) -> dict[str, str]:
    """The consumer documents for the metric rule when scanning the real
    package: the port's section of the repository README (from its
    heading to the next second-level heading outside a code block) and
    the package README, when present."""
    docs: dict[str, str] = {}
    readme = os.path.join(os.path.dirname(pkg_dir), "README.md")
    if os.path.isfile(readme):
        with open(readme, encoding="utf-8") as f:
            section = port_section(f.read())
        if section:
            docs["README.md#port"] = section
    own = os.path.join(pkg_dir, "README.md")
    if os.path.isfile(own):
        with open(own, encoding="utf-8") as f:
            docs[os.path.basename(pkg_dir) + "/README.md"] = f.read()
    return docs


def port_section(text: str) -> str:
    """The lines of `text` from the PORT_SECTION heading to the next
    "## " heading outside a fenced block (empty if it has none); lines
    before it are kept blank, so findings carry README line numbers."""
    out: list[str] = []
    inside = fenced = False
    for line in text.splitlines():
        if line.startswith("```"):
            fenced = not fenced
        if not fenced and line.startswith("## "):
            inside = line.startswith(PORT_SECTION)
        out.append(line if inside else "")
    return "\n".join(out) if any(out) else ""


# ------------------------------------------------------------- reporters
def render_text(findings: list[Finding], stats: dict) -> str:
    lines = [fd.format() for fd in findings]
    lines.append(
        f"graftlint: {len(findings)} finding(s) over {stats['files']} "
        f"file(s) ({stats['suppressed']} suppressed)")
    return "\n".join(lines)


def render_json(findings: list[Finding], stats: dict) -> str:
    """Stable machine-readable schema (documented in README):
    {"findings": [{rule, path, line, col, message}...],
     "count": N, "files": M, "suppressed": K, "rules": [...]}"""
    return json.dumps({
        "findings": [{"rule": fd.rule, "path": fd.path, "line": fd.line,
                      "col": fd.col, "message": fd.message}
                     for fd in findings],
        "count": len(findings),
        "files": stats["files"],
        "suppressed": stats["suppressed"],
        "rules": stats["rules"],
    }, indent=2)


# ------------------------------------------------------- shared AST helpers
def dotted_name(node: ast.AST) -> Optional[str]:
    """'jax.experimental.shard_map.shard_map' for nested Attribute/Name
    chains; None for anything dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_functions(tree: ast.AST) -> Iterable[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def edit_distance(a: str, b: str, cap: int = 2) -> int:
    """Levenshtein distance, early-exiting past `cap` (the metric rule
    only cares about distance <= 1)."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, 1):
            v = min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb))
            cur.append(v)
            best = min(best, v)
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]
