"""lock-discipline: guarded-in-one-method, bare-in-another attribute
access in the threaded serving/comm tiers.

The static cousin of counter and queue-depth races: if a class protects `self.x` with
`with self._lock:` (or `_cond`) when WRITING it in one method, then a
bare `self.x` in a different method is either a data race or a
happens-before argument that lives only in the author's head. The rule
flags the bare access; the fix is to take the lock, or to keep the
access and write the argument down as a justified
`# graftlint: disable=lock-discipline` on that line.

Scope: files under `serving/` and `comm/` (the tiers that actually run
threads against shared state). `__init__` is exempt — construction
happens-before thread start. Attributes that are themselves sync
primitives (name contains lock/cond/event) are exempt: accessing the
primitive bare is how locking works.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable

from .core import Finding, LintContext, Rule

_DIRS = ("serving", "comm")


def _is_lockish(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "cond" in low or "event" in low


def _self_attr(node: ast.AST):
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    summary = ("attribute written under a lock in one method, accessed "
               "bare in another")

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for rel, f in ctx.files.items():
            # scope on the ABSOLUTE directory components: a subset scan
            # rooted at (or inside) serving/ produces relative paths with
            # no 'serving' segment, which would silently disable the rule
            # for exactly the files it governs
            parts = f.abspath.replace(os.sep, "/").split("/")
            if not any(d in parts[:-1] for d in _DIRS):
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ClassDef):
                    yield from self._check_class(rel, node)

    def _check_class(self, rel: str, cls: ast.ClassDef) -> Iterable[Finding]:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # (attr, method) -> guarded?  collected per method
        guarded_writes: dict[str, set[str]] = {}
        bare_access: dict[str, list[tuple[str, ast.Attribute]]] = {}

        for m in methods:
            guarded_nodes: set[int] = set()
            for node in ast.walk(m):
                if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        _is_lockish(_self_attr(item.context_expr) or "")
                        for item in node.items):
                    for inner in ast.walk(node):
                        guarded_nodes.add(id(inner))
            for node in ast.walk(m):
                attr = _self_attr(node)
                if attr is None or _is_lockish(attr):
                    continue
                if id(node) in guarded_nodes:
                    if isinstance(node.ctx, (ast.Store, ast.Del)):
                        guarded_writes.setdefault(attr, set()).add(m.name)
                else:
                    bare_access.setdefault(attr, []).append((m.name, node))

        for attr, writers in sorted(guarded_writes.items()):
            for method, node in bare_access.get(attr, []):
                if method == "__init__" or method in writers:
                    continue
                kind = ("written" if isinstance(node.ctx,
                                                (ast.Store, ast.Del))
                        else "read")
                yield Finding(
                    self.name, rel, node.lineno, node.col_offset,
                    f"`self.{attr}` {kind} without the lock in "
                    f"`{method}` but written under a lock in "
                    f"`{'/'.join(sorted(writers))}` — either take the "
                    "lock here or justify the happens-before with a "
                    "suppression comment")
