"""knob-drift: cross-check the serve-knob registry against its consumers.

The failure mode this rule exists for: a knob gets added to config validation, passes YAML load, and is then
silently DROPPED on the deploy path because the predictor/fleet mapping
never learned about it. The registry (serving/knobs.py KNOBS) names each
knob's consumer surface; this rule asserts

  - `KNOBS` is a pure literal the linter can read without imports,
  - every "predictor" knob is read by
    `predictor.lm_predictor_from_serve_knobs` (and nothing not in the
    registry is),
  - every "fleet" knob is read by `scheduler.fleet_knobs` (ditto),
  - `scheduler.start_replica` builds LM predictors THROUGH the shared
    mapping (no side-channel serve-dict reads),
  - config.py consumes the registry's validator instead of a hand-rolled
    key list (any literal set/list/tuple in config.py holding 3+ registry
    keys is flagged as a resurrecting hand-synced copy).

The rule activates only when all four anchor files are in the scan, so
subset scans and fixture trees stage exactly what they mean to test.

The same discipline covers the wire-codec plane: comm/codec.py's
`CODEC_KNOBS` registry (pure literal, consumer="policy") is cross-checked
against `make_policy` — every registered comm_codec knob must be read there,
nothing unregistered may be — and config.py must validate comm_codec through
`validate_comm_codec` instead of a hand-rolled key list. This leg anchors on
comm/codec.py + config.py and stays dormant in scans that stage neither.

And the live-loop soak plane: soak/knobs.py's `SOAK_KNOBS`
registry (pure literal, consumer="plan") is cross-checked against
`soak_plan` — the one function translating validated soak knobs into the
loadgen/loop/slo kwargs — and config.py must validate the soak section
through `validate_soak`. Anchors on soak/knobs.py + config.py.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import Finding, LintContext, Rule, SourceFile, const_str

_ANCHORS = ("serving/knobs.py", "serving/predictor.py",
            "serving/scheduler.py", "config.py")


def _find_def(tree: ast.AST, name: str) -> Optional[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _consumed_keys(fn: ast.AST) -> set[str]:
    """String keys read off the function's first parameter via
    `sv.get("k", ...)` or `sv["k"]`."""
    params = fn.args.posonlyargs + fn.args.args
    if not params:
        return set()
    sv = params[0].arg
    keys: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == sv and node.args:
            k = const_str(node.args[0])
            if k:
                keys.add(k)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == sv:
            k = const_str(node.slice)
            if k:
                keys.add(k)
    return keys


class KnobDriftRule(Rule):
    name = "knob-drift"
    summary = ("serve-knob registry vs predictor/fleet mapping "
               "cross-check")

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        yield from self._serve_leg(ctx)
        yield from self._codec_leg(ctx)
        yield from self._soak_leg(ctx)

    def _serve_leg(self, ctx: LintContext) -> Iterable[Finding]:
        anchors = {a: ctx.get(a) for a in _ANCHORS}
        if any(v is None for v in anchors.values()):
            return  # subset scan: nothing to cross-check against
        knobs_f = anchors["serving/knobs.py"]
        registry = self._load_registry(knobs_f)
        if isinstance(registry, Finding):
            yield registry
            return
        yield from self._check_mapping(
            anchors["serving/predictor.py"], "lm_predictor_from_serve_knobs",
            {k for k, s in registry.items()
             if s.get("consumer") == "predictor"}, registry, "predictor")
        yield from self._check_mapping(
            anchors["serving/scheduler.py"], "fleet_knobs",
            {k for k, s in registry.items()
             if s.get("consumer") == "fleet"}, registry, "fleet")
        yield from self._check_start_replica(anchors["serving/scheduler.py"])
        yield from self._check_config(anchors["config.py"], registry)

    # ------------------------------------------------------- codec leg
    def _codec_leg(self, ctx: LintContext) -> Iterable[Finding]:
        codec_f = ctx.get("comm/codec.py")
        config_f = ctx.get("config.py")
        if codec_f is None or config_f is None:
            return  # subset scan: codec plane not staged
        registry = self._load_literal_registry(
            codec_f, "CODEC_KNOBS", "policy", "comm/codec.py CODEC_KNOBS")
        if isinstance(registry, Finding):
            yield registry
            return
        yield from self._check_mapping(
            codec_f, "make_policy", set(registry), registry, "policy",
            registry_label="comm/codec.py CODEC_KNOBS")
        # config.py must validate comm_codec THROUGH the codec module
        imports_codec = any(
            isinstance(n, ast.ImportFrom) and n.module
            and n.module.split(".")[-2:] == ["comm", "codec"]
            for n in ast.walk(config_f.tree))
        calls_validator = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name)
                 and n.func.id == "validate_comm_codec")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "validate_comm_codec"))
            for n in ast.walk(config_f.tree))
        if not (imports_codec and calls_validator):
            yield Finding(
                self.name, config_f.path, 1, 0,
                "config.py does not validate comm_codec through "
                "comm/codec.py (`from .comm.codec import "
                "validate_comm_codec`) — the validated key set can drift "
                "from the policy consumer")
        yield from self._check_hand_synced(
            config_f, registry, "comm/codec.py CODEC_KNOBS")

    # -------------------------------------------------------- soak leg
    def _soak_leg(self, ctx: LintContext) -> Iterable[Finding]:
        soak_f = ctx.get("soak/knobs.py")
        config_f = ctx.get("config.py")
        if soak_f is None or config_f is None:
            return  # subset scan: soak plane not staged
        registry = self._load_literal_registry(
            soak_f, "SOAK_KNOBS", "plan", "soak/knobs.py")
        if isinstance(registry, Finding):
            yield registry
            return
        yield from self._check_mapping(
            soak_f, "soak_plan", set(registry), registry, "plan",
            registry_label="soak/knobs.py SOAK_KNOBS")
        # config.py must validate the soak section THROUGH the soak module
        imports_soak = any(
            isinstance(n, ast.ImportFrom) and n.module
            and n.module.split(".")[-2:] == ["soak", "knobs"]
            for n in ast.walk(config_f.tree))
        calls_validator = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name)
                 and n.func.id == "validate_soak")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "validate_soak"))
            for n in ast.walk(config_f.tree))
        if not (imports_soak and calls_validator):
            yield Finding(
                self.name, config_f.path, 1, 0,
                "config.py does not validate the soak section through "
                "soak/knobs.py (`from .soak.knobs import validate_soak`) "
                "— the validated key set can drift from the plan consumer")
        yield from self._check_hand_synced(
            config_f, registry, "soak/knobs.py SOAK_KNOBS")

    def _load_literal_registry(self, f: SourceFile, var: str,
                               consumer: str, label: str):
        """Shared literal-registry loader for the codec and soak legs:
        the assignment must literal_eval and every entry must carry the
        leg's consumer tag."""
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == var
                    for t in node.targets):
                try:
                    reg = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        f"{var} must stay a pure literal — graftlint "
                        "reads it with ast.literal_eval")
                bad = [k for k, s in reg.items()
                       if not isinstance(s, dict)
                       or s.get("consumer") != consumer]
                if bad:
                    return Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        f"registry entries {sorted(bad)} missing the "
                        f"{consumer!r} consumer tag — the drift check "
                        "cannot assign them a mapping")
                return reg
        return Finding(self.name, f.path, 1, 0,
                       f"{label.split()[0]} defines no {var} registry")

    def _check_hand_synced(self, f: SourceFile, registry: dict,
                           label: str) -> Iterable[Finding]:
        """A literal collection holding 3+ registry keys is a resurrected
        hand-synced copy of the key set."""
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
                strs = {const_str(e) for e in node.elts} - {None}
                hits = strs & set(registry)
                if len(hits) >= 3:
                    yield Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        f"literal key list holding {len(hits)} registry "
                        f"knobs — a hand-synced copy of {label} that "
                        "WILL drift; iterate the registry instead")

    # ------------------------------------------------------------------
    def _load_registry(self, f: SourceFile):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "KNOBS"
                    for t in node.targets):
                try:
                    reg = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        "KNOBS must stay a pure literal — graftlint reads "
                        "it with ast.literal_eval")
                bad = [k for k, s in reg.items()
                       if not isinstance(s, dict)
                       or s.get("consumer") not in ("predictor", "fleet")]
                if bad:
                    return Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        f"registry entries {sorted(bad)} missing a "
                        "'consumer' tag ('predictor' or 'fleet') — the "
                        "drift check cannot assign them a mapping")
                return reg
        return Finding(self.name, f.path, 1, 0,
                       "serving/knobs.py defines no KNOBS registry")

    def _check_mapping(self, f: SourceFile, fn_name: str, owned: set[str],
                       registry: dict, surface: str,
                       registry_label: str = "serving/knobs.py"
                       ) -> Iterable[Finding]:
        fn = _find_def(f.tree, fn_name)
        if fn is None:
            yield Finding(
                self.name, f.path, 1, 0,
                f"`{fn_name}` not found — the {surface} half of THE "
                "serve-knob mapping is gone; the registry's "
                f"{sorted(owned)} knobs have no consumer")
            return
        consumed = _consumed_keys(fn)
        for k in sorted(owned - consumed):
            yield Finding(
                self.name, f.path, fn.lineno, fn.col_offset,
                f"knob `{k}` is validated at config load ({registry_label} "
                f"tags it consumer={surface!r}) but `{fn_name}` never reads "
                "it — validated-then-dropped, the exact drift the registry "
                "exists to prevent")
        for k in sorted(consumed - set(registry)):
            yield Finding(
                self.name, f.path, fn.lineno, fn.col_offset,
                f"`{fn_name}` reads knob `{k}` that {registry_label} does "
                "not register — config validation would reject any YAML "
                "naming it, so the read is dead (or the registry is "
                "missing an entry)")
        for k in sorted(consumed & set(registry)):
            if registry[k].get("consumer") != surface:
                yield Finding(
                    self.name, f.path, fn.lineno, fn.col_offset,
                    f"`{fn_name}` reads knob `{k}` but the registry tags "
                    f"it consumer={registry[k].get('consumer')!r} — two "
                    "surfaces consuming one knob drift apart; move it or "
                    "retag it")

    def _check_start_replica(self, f: SourceFile) -> Iterable[Finding]:
        fn = _find_def(f.tree, "start_replica")
        if fn is None:
            return
        calls_mapping = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name)
                 and n.func.id == "lm_predictor_from_serve_knobs")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "lm_predictor_from_serve_knobs"))
            for n in ast.walk(fn))
        if not calls_mapping:
            yield Finding(
                self.name, f.path, fn.lineno, fn.col_offset,
                "`start_replica` no longer builds LM predictors through "
                "`lm_predictor_from_serve_knobs` — the deploy surface has "
                "left THE shared knob mapping and will drift from config")

    def _check_config(self, f: SourceFile, registry: dict
                      ) -> Iterable[Finding]:
        imports_registry = any(
            isinstance(n, ast.ImportFrom) and n.module
            and n.module.split(".")[-2:] == ["serving", "knobs"]
            for n in ast.walk(f.tree))
        calls_validator = any(
            isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Name)
                 and n.func.id == "validate_serve_args")
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "validate_serve_args"))
            for n in ast.walk(f.tree))
        if not (imports_registry and calls_validator):
            yield Finding(
                self.name, f.path, 1, 0,
                "config.py does not validate serve_args through "
                "serving/knobs.py (`from .serving.knobs import "
                "validate_serve_args`) — the validated key set can drift "
                "from the consumer mappings again")
        # a resurrected hand-synced key list: any literal collection in
        # config.py holding 3+ registry keys is a second copy of the set
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
                strs = {const_str(e) for e in node.elts} - {None}
                hits = strs & set(registry)
                if len(hits) >= 3:
                    yield Finding(
                        self.name, f.path, node.lineno, node.col_offset,
                        f"literal key list holding {len(hits)} registry "
                        "knobs — this is a hand-synced copy of "
                        "serving/knobs.py and WILL drift; iterate the "
                        "registry instead")
