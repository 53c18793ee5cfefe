"""graftlint on the port (`fedml_tpu_torch/analysis/`), held against the
JAX package's analyzer (`fedml_tpu/analysis/`):

- every carried rule gives JAX's findings (rule, path, line, column,
  message) and suppression counts on the staged fixtures under
  tests/lint_fixtures/, rule by rule and all rules at once;
- in-trace-purity's torch leg (`torch.func` transforms) on its own
  fixture, which the JAX analyzer, blind to torch, passes;
- the port's own tree reports zero findings (the metric rule reading the
  README's port section), with the engine's justified suppressions;
- the rule catalog, the unknown-rule error, parse errors, the reporters'
  schema, and the `lint` verb and `lint_clean` probe.

Pure stdlib ast: no torch work, about 10 s.
"""
import json
import os
import shutil

import pytest

from fedml_tpu import analysis as janalysis
from fedml_tpu_torch import analysis as panalysis
from fedml_tpu_torch.analysis.core import (all_rules, edit_distance,
                                           port_section)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
RULES = ["donation-after-use", "retrace-hazard", "knob-drift",
         "metric-registry", "lock-discipline", "in-trace-purity"]

# each fixture tree with the rule(s) it stages and the documents the
# metric rule reads there (tests/test_lint.py's staging)
_METRIC_DOC = {"FIXTURE.md": "\n".join([
    "counters: `fed.rounds_total` and the `fed.participation.*`",
    "family; trace spans: `serving.swap.fixture`.",
    "stale claim: `serving.ghost_series` was renamed away."])}
_TREES = [
    ("trace/donation.py", "donation-after-use", None),
    ("trace/retrace.py", "retrace-hazard", None),
    ("trace/purity.py", "in-trace-purity", None),
    ("locks", "lock-discipline", None),
    ("knobs", "knob-drift", None),
    ("knobs_clean", "knob-drift", None),
    ("knobs_suppressed", "knob-drift", None),
    ("codec_knobs", "knob-drift", None),
    ("soak_knobs", "knob-drift", None),
    ("metrics", "metric-registry", _METRIC_DOC),
    ("slo_events", "metric-registry", None),
    ("obs_fleet", "metric-registry", None),
]


def _rows(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


@pytest.mark.parametrize("tree,rule,docs", _TREES,
                         ids=[t[0] for t in _TREES])
def test_rule_matches_jax_on_fixture(tree, rule, docs):
    path = [os.path.join(FIXTURES, tree)]
    got = [mod.run_lint(path, rules=[rule], extra_docs=docs or {})
           for mod in (panalysis, janalysis)]
    assert _rows(got[0][0]) == _rows(got[1][0])
    assert got[0][1] == got[1][1]
    if tree not in ("knobs_clean", "knobs_suppressed"):
        assert got[0][0], "the fixture stages findings"


def test_all_rules_match_jax_on_every_fixture():
    got = [mod.run_lint([FIXTURES], extra_docs=_METRIC_DOC)
           for mod in (panalysis, janalysis)]
    assert _rows(got[0][0]) == _rows(got[1][0]) and got[0][1] == got[1][1]


_TORCH_PURITY = '''"""torch.func fixture for in-trace-purity."""
import random
import time

import numpy as np
import torch
from torch.func import grad, vmap


def _jitter(x):
    return x * np.random.rand()          # FINDING: reached from vmap


def client_step(p, x):
    t = time.perf_counter()              # FINDING: one clock for a group
    return _jitter(p) * x + t


def run(ps, xs):
    return vmap(client_step)(ps, xs)


def loss(p, x):
    np.random.seed(1)                    # FINDING: under torch.func.grad
    return (p * x).sum()


def g(p, x):
    return torch.func.grad(loss)(p, x)


def outside(x):
    return x + time.time()               # never transformed: clean


def local_rng(p, x):
    rs = np.random.RandomState(0)        # local state: clean
    return p * x + rs.rand()


def h(p, x):
    return grad(local_rng)(p, x) + random.random()
'''


def test_in_trace_purity_torch_leg(tmp_path):
    path = tmp_path / "tfunc.py"
    path.write_text(_TORCH_PURITY)
    marked = {i for i, ln in enumerate(_TORCH_PURITY.splitlines(), 1)
              if "# FINDING" in ln}
    findings, _ = panalysis.run_lint([str(path)], rules=["in-trace-purity"],
                                     extra_docs={})
    assert {f.line for f in findings} == marked
    msgs = " ".join(f.message for f in findings)
    assert "_jitter" in msgs and "client_step" in msgs and "loss" in msgs
    # the JAX analyzer does not know torch.func
    jf, _ = janalysis.run_lint([str(path)], rules=["in-trace-purity"],
                               extra_docs={})
    assert jf == []


def test_port_tree_zero_findings():
    """The gate: the whole port tree, with the README's port section as
    the metric rule's document, reports zero findings; the engine's
    documented thread-ownership suppressions are there."""
    findings, stats = panalysis.run_lint()
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)
    assert stats["files"] > 130 and stats["rules"] == RULES
    assert stats["suppressed"] >= 7
    pkg = os.path.join(ROOT, "fedml_tpu_torch")
    f2, s2 = panalysis.run_lint([os.path.join(pkg, "serving", "engine.py")],
                                rules=["lock-discipline"], extra_docs={})
    assert f2 == [] and s2["suppressed"] >= 7


def test_metric_rule_reads_the_port_section(tmp_path):
    """The metric rule's document is the README's port section only: a
    phantom there is a finding, one in the JAX sections is not read."""
    readme = open(os.path.join(ROOT, "README.md"), encoding="utf-8").read()
    section = port_section(readme)
    lines = [ln for ln in section.splitlines() if ln]
    assert lines[0].startswith("## PyTorch/CUDA port")
    # findings keep README line numbers: the section sits where it stands
    assert section.splitlines().index(lines[0]) == \
        readme.splitlines().index(lines[0])
    assert "## Static analysis" not in section
    pkg = os.path.join(ROOT, "fedml_tpu_torch")
    docs = {"README.md#port": section + "\nthe `fed.phantom_series`."}
    findings, _ = panalysis.run_lint([pkg], rules=["metric-registry"],
                                     extra_docs=docs)
    assert [f.message.split("`")[1] for f in findings] == \
        ["fed.phantom_series"]


def test_injected_knob_drift_is_caught(tmp_path):
    """The self-enforcement: a serve knob added to the registry that no
    mapping consumes makes the port's tree fail, with that one
    finding."""
    pkg = tmp_path / "fedml_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "fedml_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    knobs = pkg / "serving" / "knobs.py"
    src = knobs.read_text()
    assert "KNOBS = {" in src
    knobs.write_text(src.replace(
        "KNOBS = {", 'KNOBS = {\n    "drifted_knob": {"kind": "int", '
        '"consumer": "predictor"},', 1))
    findings, _ = panalysis.run_lint([str(pkg)], rules=["knob-drift"],
                                     extra_docs={})
    assert len(findings) == 1 and "drifted_knob" in findings[0].message


def test_rule_catalog_unknown_rule_and_parse_error(tmp_path):
    assert [r.name for r in all_rules()] == RULES == \
        [r.name for r in janalysis.all_rules()]
    assert [r.summary for r in all_rules()] == \
        [r.summary for r in janalysis.all_rules()]
    for mod in (panalysis, janalysis):
        with pytest.raises(ValueError, match="unknown rule"):
            mod.run_lint([FIXTURES], rules=["no-such-rule"])
        with pytest.raises(OSError, match="does not exist"):
            mod.run_lint([os.path.join(FIXTURES, "no_such_dir")])
    (tmp_path / "broken.py").write_text("def oops(:\n")
    findings, _ = panalysis.run_lint([str(tmp_path)], extra_docs={})
    assert [f.rule for f in findings] == ["parse-error"]
    assert edit_distance("fed.rounds_total", "fed.round_total", 1) == 1
    assert edit_distance("serving.ttft", "serving.tbt", 1) > 1


def test_reporters_and_lint_verb(capsys):
    from fedml_tpu_torch.__main__ import main

    path = os.path.join(FIXTURES, "trace", "retrace.py")
    f, s = panalysis.run_lint([path], rules=["retrace-hazard"])
    jf, js = janalysis.run_lint([path], rules=["retrace-hazard"])
    assert panalysis.render_text(f, s) == janalysis.render_text(jf, js)
    assert panalysis.render_json(f, s) == janalysis.render_json(jf, js)
    rc = main(["lint", "--format", "json", "--rules", "retrace-hazard",
               path])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["count"] == 3
    assert set(doc) == {"findings", "count", "files", "suppressed",
                        "rules"}
    rc = main(["lint", "--rules", "donation-after-use",
               os.path.join(FIXTURES, "knobs_clean")])
    assert rc == 0 and "0 finding(s)" in capsys.readouterr().out
    assert main(["lint", os.path.join(FIXTURES, "no_such_dir")]) == 2
    capsys.readouterr()


def test_diagnosis_lint_clean_probe(capsys):
    from fedml_tpu_torch.__main__ import main

    rc = main(["diagnosis", "--device", "cpu", "--only", "lint_clean"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"] is True
    probe = out["checks"]["lint_clean"]
    assert probe["ok"] and probe["files"] > 130 and probe["scan_s"] < 20
    assert probe["rules"] == len(RULES)
