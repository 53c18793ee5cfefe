"""graftlint: the repository's own static analysis, for the port (port of
`fedml_tpu/analysis/`).

Machine-checked invariants between the port's layers, run as a
stdlib-`ast` analyzer over the package tree: the one serve-knob mapping
(and the codec and soak registries), metric-name consistency between
emit sites, `top` and the documentation, lock discipline in the threaded
serving and comm tiers, and host side effects inside function
transforms. `donation-after-use` and `retrace-hazard` are kept under the
JAX package's names and held to its fixtures; the port donates no buffer
and builds no compiled program, so they find nothing on its tree.

Entry points:
  - `python -m fedml_tpu_torch lint [--format text|json] [--rules a,b]
    [--list-rules] [paths]`
  - `fedml_tpu_torch.analysis.run_lint(...)` (the zero-findings test and
    the `lint_clean` diagnosis probe call it in process)

Suppression: append `# graftlint: disable=<rule>[,<rule>...]` to the
flagged line, with the justification in the comment around it.

Standard library only (ast, re, json): it runs without torch.
"""
from __future__ import annotations

from .core import (  # noqa: F401
    Finding,
    LintContext,
    all_rules,
    render_json,
    render_text,
    run_lint,
)

__all__ = ["Finding", "LintContext", "all_rules", "run_lint",
           "render_text", "render_json"]
