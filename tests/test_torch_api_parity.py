"""The port's public surface against the JAX package's.

Both packages are parsed with `ast`; neither is imported. For every source
file of `fedml_tpu/` the port must have the file of the same path under
`fedml_tpu_torch/`, and for every module both have:

- every public top-level name of the JAX module (a def, a class, an
  assignment; in a package's `__init__.py` also what it re-exports from
  its own submodules and its `__all__`) is bound in the port's module
  (by any statement, an import included, or by a lazy `__getattr__`
  table; a name listed in `__all__` alone does not count);
- every public method of a class both modules define (inherited ones
  too, through bases defined in the package) is a method of the port's
  class;
- every keyword of a function or method both have (a class's
  constructor: its `__init__`, else its dataclass / flax fields) is a
  parameter of the port's, where a port `**kwargs` counts for the
  keywords of the function in the same module it is passed on to.

A difference passes only through an `ALLOW` entry: `(jax_qualname,
port_counterpart or None, reason)`. A qualname is `module:Name`,
`module:Class.method`, `module:func(kw=)` or `module:Class(kw=)` (dotted
module, the package root as `fedml_tpu`), or a file path for a source
file; `*` in it matches any run of characters. The counterpart, written
the same way in the port's terms, must exist there. The reason names the
deviation. `test_allowlist_is_current` fails when an entry has gone
stale: it matches no difference left (the JAX name is gone, or the port
now has it) or its counterpart is missing.

To add an entry: run this file, read the failing qualname, and add
`(qualname, counterpart, reason)` to ALLOW in its group, naming ROADMAP's
"Deviations by design" where the reason is a deviation listed there.
"""
from __future__ import annotations

import ast
import fnmatch
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = "fedml_tpu", "fedml_tpu_torch"
SOURCES = ("*.py", "*.cpp", "*.cc", "*.h", "*.cu", "*.cuh")

_RNG = "rng (a jax.random key) -> an explicit torch.Generator (ops/keys.py)"
_PARAMS = ("params (a flax tree) -> the port's state dict, bound in the "
           "model or passed by name (ROADMAP deviations)")
_FLAX = ("flax module field -> the port's nn.Module constructor takes "
         "ModelDims / its own arguments (ROADMAP deviations)")
_APPLY = ("apply_fn -> the port takes the hub module (`model`), applied "
          "through hub.apply_fn, or any (params, x) callable")
_XLA = ("XLA retrace guard; no compiled programs in the port (ROADMAP "
        "deviations)")
_MESH = ("jax.sharding / shard_map placement; the port's meshes are "
         "torch.distributed DeviceMesh ranks (parallel/mesh.py)")
_PYTREE = "a typing alias of JAX pytrees; the port's trees are dicts"

ALLOW: list[tuple] = [
    # -- files
    ("fedml_tpu/native/fedml_native.cpp",
     ("fedml_tpu_torch/native/crc32c.cpp",
      "fedml_tpu_torch/native/finite_field.cpp",
      "fedml_tpu_torch/native/edge_trainer.cpp"),
     "one library per use (the wire CRC, the finite field, the edge "
     "trainers), each built by g++ at first use"),
    # -- top-level names
    ("fedml_tpu.*:Pytree", None, _PYTREE),
    ("fedml_tpu.__main__:cmd_bench", None,
     "the port's benchmark comes in a `benchmark` PR of its own"),
    ("fedml_tpu.native:log", None, "a module logger, not API: the port's "
     "native build raises instead of logging a fallback"),
    ("fedml_tpu.llm.decode:stack_blocks", None,
     "scan_layers' stacked [L, ...] layout; the port's blocks are a "
     "per-layer list (ROADMAP deviations)"),
    ("fedml_tpu.llm.decode:stack_adapter_blocks", None,
     "scan_layers' stacked adapters; the port's adapters are per layer"),
    ("fedml_tpu.parallel.mesh:client_sharding", None, _MESH),
    ("fedml_tpu.parallel.mesh:replicated", None, _MESH),
    ("fedml_tpu.parallel.round:resolve_param_specs",
     "fedml_tpu_torch.parallel.partition:resolve",
     "the rule tables resolve in parallel/partition.py; no device_put"),
    ("fedml_tpu.parallel.round:shard_server_params",
     "fedml_tpu_torch.parallel.partition:shard_params", _MESH),
    ("fedml_tpu.serving:JaxPredictor",
     "fedml_tpu_torch.serving:TorchPredictor",
     "the predictor of a (params, x) callable runs torch"),
    ("fedml_tpu.serving.predictor:JaxPredictor",
     "fedml_tpu_torch.serving.predictor:TorchPredictor",
     "the predictor of a (params, x) callable runs torch"),
    ("fedml_tpu.serving.export:jax_device_get", None,
     "JAX device-to-host transfer; a state dict moves with .cpu()"),
    ("fedml_tpu.utils:maybe_enable_compilation_cache", None,
     "XLA's persistent compilation cache; nothing is compiled ahead "
     "(kernels build once into fedml_tpu_torch/_build)"),
    ("fedml_tpu.utils.flops:tpu_spec_peak_tflops",
     "fedml_tpu_torch.ops.cost:peak_flops",
     "TPU data-sheet peaks; the card's peaks are in ops/cost.py"),
    ("fedml_tpu.utils.metrics:track_jit", None, _XLA),
    ("fedml_tpu.core.algorithm:FULL", None,
     "an aggregation-mode tag no algorithm of either package declares: "
     "the port's round takes the FULL path from its aggregate_full hook "
     "(parallel/round.py)"),
    ("fedml_tpu.core.registry:DEFENSES", "fedml_tpu_torch.security:DEFENSES",
     "a registry no module of either package fills or reads; the "
     "defenses are named by security's tuple"),
    ("fedml_tpu.core.registry:ATTACKS", "fedml_tpu_torch.security:ATTACKS",
     "a registry no module of either package fills or reads; the "
     "attacks are named by security's tuple"),
    # -- methods
    ("fedml_tpu.serving.engine:DecodeEngine.program_counts", None,
     "counts of live jit programs; the engine runs eager torch and its "
     "kernels (ROADMAP deviations)"),
    ("fedml_tpu.simulation.fedgkt:GKTClientNet.setup", None,
     "flax's module setup hook; torch modules build in __init__"),
    # -- keywords: rng -> torch.Generator
    ("fedml_tpu.algorithms.fedgan:init_gan_params(rng=)",
     "fedml_tpu_torch.algorithms.fedgan:init_gan_params(generator=)", _RNG),
    ("fedml_tpu.compression:*_compress(rng=)",
     "fedml_tpu_torch.compression:qsgd_compress(gen=)", _RNG),
    ("fedml_tpu.core.algorithm:make_batch_indices(rng=)",
     "fedml_tpu_torch.core.algorithm:make_batch_indices(generator=)", _RNG),
    ("fedml_tpu.dp.mechanisms:add_*_noise(rng=)",
     "fedml_tpu_torch.dp.mechanisms:add_gaussian_noise(gen=)", _RNG),
    ("fedml_tpu.llm:federated_lora(rng=)",
     "fedml_tpu_torch.llm:federated_lora(generator=)", _RNG),
    ("fedml_tpu.llm.lora:lora_init(rng=)",
     "fedml_tpu_torch.llm.lora:lora_init(generator=)", _RNG),
    ("fedml_tpu.llm.quant:synth_quantized_base(rng=)",
     "fedml_tpu_torch.llm.quant:synth_quantized_base(generator=)", _RNG),
    ("fedml_tpu.models.hub:init_params(rng=)",
     "fedml_tpu_torch.models.hub:init_params(generator=)", _RNG),
    ("fedml_tpu.security.attacks:dlg_attack(rng=)",
     "fedml_tpu_torch.security.attacks:dlg_attack(generator=)", _RNG),
    ("fedml_tpu.security.attacks:invert_gradient_attack(rng=)",
     "fedml_tpu_torch.security.attacks:invert_gradient_attack(generator=)",
     _RNG),
    ("fedml_tpu.security.attacks:byzantine_attack(rng=)",
     "fedml_tpu_torch.security.attacks:byzantine_attack(evil=)",
     "the random mode's draw is made by the round from its key "
     "(ops/keys.py) and passed in as `evil`"),
    ("fedml_tpu.security.defenses:*(rng=)",
     "fedml_tpu_torch.security.defenses:weak_dp_aggregate(noise=)",
     "the noise is drawn by the round from its key (ops/keys.py) and "
     "passed in as `noise`"),
    # -- keywords: flax trees -> state dicts
    ("fedml_tpu.llm:federated_lora(base_params=)",
     "fedml_tpu_torch.llm:federated_lora(base_state=)", _PARAMS),
    ("fedml_tpu.llm:make_fedllm_seq_round(base_params=)",
     "fedml_tpu_torch.llm:make_fedllm_seq_round(base_state=)", _PARAMS),
    ("fedml_tpu.llm.lora:lora_merge(base_params=)",
     "fedml_tpu_torch.llm.lora:lora_merge(base=)", _PARAMS),
    ("fedml_tpu.llm.lora:lora_apply_fn(base_params=)", None, _PARAMS),
    ("fedml_tpu.llm.quant:quantize_tree_int8(params=)",
     "fedml_tpu_torch.llm.quant:quantize_tree_int8(state=)", _PARAMS),
    ("fedml_tpu.llm.quant:dequantize_tree(qparams=)",
     "fedml_tpu_torch.llm.quant:dequantize_tree(qstate=)", _PARAMS),
    ("fedml_tpu.llm.quant:quant_bytes(qparams=)",
     "fedml_tpu_torch.llm.quant:quant_bytes(qstate=)", _PARAMS),
    ("fedml_tpu.llm.quant:lm_head_logits(params=)",
     "fedml_tpu_torch.llm.quant:lm_head_logits(model=)", _PARAMS),
    ("fedml_tpu.llm.quant:lora_apply_fn_quant(qbase=)", None,
     _PARAMS + "; the int8 base is the model's own (TransformerLM."
     "from_state of quantize_tree_int8)"),
    ("fedml_tpu.serving:lm_predictor_from_config(params=)", None, _PARAMS),
    ("fedml_tpu.serving.predictor:lm_predictor_from_serve_knobs(params=)",
     None, _PARAMS),
    ("fedml_tpu.serving.predictor:GreedyLMPredictor(params=)", None,
     _PARAMS),
    ("fedml_tpu.serving.engine:DecodeEngine(params=)", None, _PARAMS),
    ("fedml_tpu.native:Native*Trainer.train(params_flat=)",
     "fedml_tpu_torch.native:NativeLRTrainer.train(params=)",
     "takes the flat native vector or the port's parameter dict and "
     "answers in kind"),
    # -- keywords: apply_fn -> the hub module
    ("fedml_tpu.cross_cloud:run_cross_cloud(apply_fn=)",
     "fedml_tpu_torch.cross_cloud:run_cross_cloud(model=)", _APPLY),
    ("fedml_tpu.cross_silo.hierarchical:run_hierarchical(apply_fn=)",
     "fedml_tpu_torch.cross_silo.hierarchical:run_hierarchical(model=)",
     _APPLY),
    ("fedml_tpu.cross_silo.trainer:SiloTrainer(apply_fn=)",
     "fedml_tpu_torch.cross_silo.trainer:SiloTrainer(model=)", _APPLY),
    ("fedml_tpu.models.hub:init_params(input_shape=)",
     "fedml_tpu_torch.models.hub:create(input_shape=)",
     "a torch module is built at its input shape (hub.create), so "
     "init_params draws for a built module"),
    # -- keywords: flax fields -> nn.Module constructors
    ("fedml_tpu.llm.transformer:TransformerLM(*=)",
     "fedml_tpu_torch.llm.transformer:TransformerLM(dims=)", _FLAX),
    ("fedml_tpu.llm.transformer:Block(*=)", None, _FLAX),
    ("fedml_tpu.llm.transformer:RMSNorm(eps=)", None, _FLAX),
    ("fedml_tpu.models.*(strides=)", None,
     _FLAX + "; strides are (s, s) tuples there, an int `stride` here"),
    ("fedml_tpu.parallel.round:RoundParts(make_carry=)", None,
     "the chunked round's carry is made by RoundParts.zero_carry"),
    # -- keywords: JAX-only
    ("fedml_tpu.ops.flash_attention:flash_attention(interpret=)", None,
     "Pallas interpret mode; a CPU tensor takes the plain version"),
    ("fedml_tpu.ops.paged_attention:paged_attention(interpret=)", None,
     "Pallas interpret mode; a CPU tensor takes the plain version"),
    ("fedml_tpu.parallel.seq:*_attention(axis_name=)",
     "fedml_tpu_torch.parallel.seq:ring_attention(axis=)",
     "a shard_map axis name -> a DeviceMesh and its axis"),
    ("fedml_tpu.parallel.hier:shard_hier_data(client_axis=)", None,
     "the rank's layout holds every client (the round gathers its cohort "
     "by id), so no client axis places data"),
    ("fedml_tpu.llm.decode:make_*(alpha=)", None,
     "the decode functions take a merged model: adapters are merged once "
     "(serving.engine.merged_model), so no LoRA scale reaches them"),
    ("fedml_tpu.llm.decode:make_paged_kv_decode(mesh=)",
     "fedml_tpu_torch.serving.engine:DecodeEngine(mesh=)",
     "the tensor-parallel split lives in the model (TransformerLM(tp=)); "
     "the engine takes the mesh"),
    ("fedml_tpu.serving.engine:prepare_adapter_swap(n_layers=)", None,
     "scan_layers' stacked adapters need the layer count; the port's "
     "are per layer"),
    ("fedml_tpu.serving.engine:_Admission(total=)", None,
     "the admission's total is computed from its prompt"),
    ("fedml_tpu.utils.xla_ledger:capture(jitted=)",
     "fedml_tpu_torch.utils.xla_ledger:capture(fn=)",
     "a jitted program -> an eager function, captured under "
     "utils/flops.counting"),
]


# ---------------------------------------------------------------- surfaces
class Module:
    """What one module binds, defines and declares."""

    def __init__(self, pkg: str, dotted: str, tree: ast.Module,
                 is_package: bool):
        self.pkg, self.dotted, self.is_package = pkg, dotted, is_package
        self.bound: set = set()      # every top-level binding, any kind
        self.public: set = set()     # the public surface (JAX side)
        self.classes: dict = {}      # name -> ast.ClassDef
        self.funcs: dict = {}        # name -> ast.FunctionDef
        self.imports: dict = {}      # name -> (dotted module, name)
        self.star: list = []         # dotted modules imported with *
        for node in _top(tree.body):
            self._bind(node)

    def _bind(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.funcs[node.name] = node
            self._name(node.name, public=True)
            if node.name == "__getattr__":
                self.bound |= {c.value for c in ast.walk(node)
                               if isinstance(c, ast.Constant)
                               and isinstance(c.value, str)}
        elif isinstance(node, ast.ClassDef):
            self.classes[node.name] = node
            self._name(node.name, public=True)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        self._name(n.id, public=True)
                        if n.id == "__all__":
                            # declared, not bound: a name in it counts
                            # only where a statement or a lazy table
                            # binds it
                            self.public |= _strings(node.value)
            if isinstance(node.value, ast.Dict):
                # a lazy table: {"Name": "submodule", ...}
                self.bound |= _strings(node.value)
        elif isinstance(node, ast.Import):
            for a in node.names:
                self._name((a.asname or a.name).split(".")[0], public=False)
        elif isinstance(node, ast.ImportFrom):
            src = self._resolve(node)
            for a in node.names:
                if a.name == "*":
                    self.star.append(src)
                    continue
                name = a.asname or a.name
                self.imports[name] = (src, a.name)
                # a package re-exports what it imports from its own
                # submodules
                own = (self.is_package and node.level == 1
                       and node.module is not None)
                self._name(name, public=own)

    def _name(self, name: str, public: bool) -> None:
        self.bound.add(name)
        if public and not name.startswith("_"):
            self.public.add(name)

    def _resolve(self, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = self.dotted.split(".")
        base = parts if self.is_package else parts[:-1]
        base = base[:len(base) - (node.level - 1)]
        return ".".join(base + ([node.module] if node.module else []))


def _top(body):
    """Top-level statements, through `if` / `try` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top(node.body)
            yield from _top(node.orelse)
        elif isinstance(node, ast.Try):
            for b in (node.body, node.orelse, node.finalbody,
                      *[h.body for h in node.handlers]):
                yield from _top(b)
        else:
            yield node


def _strings(node) -> set:
    if isinstance(node, ast.Dict):
        return {k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return {e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


@lru_cache(maxsize=None)
def package(pkg: str) -> dict:
    """{dotted module: Module} of one package."""
    out = {}
    for p in sorted((ROOT / pkg).rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        is_pkg = parts[-1] == "__init__"
        dotted = ".".join(parts[:-1] if is_pkg else parts)
        out[dotted] = Module(pkg, dotted, ast.parse(p.read_text()), is_pkg)
    for m in out.values():   # `from .x import *` binds x's public names
        for src in m.star:
            if src in out:
                m.bound |= out[src].public
                if m.is_package:
                    m.public |= out[src].public
    return out


def _class(pkg: str, dotted: str, name: str, seen=()):
    """(module, ClassDef) of `name` as `dotted` sees it: defined there or
    imported from a module of the package; None otherwise."""
    mods = package(pkg)
    m = mods.get(dotted)
    if m is None or (dotted, name) in seen:
        return None
    if name in m.classes:
        return m, m.classes[name]
    if name in m.imports:
        src, orig = m.imports[name]
        return _class(pkg, src, orig, seen + ((dotted, name),))
    return None


def _lineage(pkg: str, dotted: str, name: str) -> list:
    """The class and its bases resolvable in the package, nearest first:
    [(module, ClassDef), ...]."""
    found = _class(pkg, dotted, name)
    if found is None:
        return []
    m, cls = found
    out = [found]
    for b in cls.bases:
        base = b.id if isinstance(b, ast.Name) else None
        if base:
            out += _lineage(pkg, m.dotted, base)
    return out


def methods(pkg: str, dotted: str, name: str) -> dict:
    """{method name: FunctionDef} of a class, inherited ones included."""
    out: dict = {}
    for _m, cls in reversed(_lineage(pkg, dotted, name)):
        for b in cls.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[b.name] = b
    return out


def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def keywords(pkg: str, dotted: str, fn, depth: int = 0) -> set:
    """A function's parameter names; a `**kwargs` adds the keywords of
    the package function in the same module it is passed on to."""
    names = set(_params(fn))
    kw = fn.args.kwarg.arg if fn.args.kwarg else None
    if kw is None or depth > 3:
        return names
    m = package(pkg)[dotted]
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call) or not isinstance(call.func,
                                                            ast.Name):
            continue
        if any(k.arg is None and isinstance(k.value, ast.Name)
               and k.value.id == kw for k in call.keywords):
            target = m.funcs.get(call.func.id)
            if target is not None:
                names |= keywords(pkg, dotted, target, depth + 1)
    return names


def ctor(pkg: str, dotted: str, name: str) -> set:
    """A class's constructor keywords: its (inherited) `__init__`'s, else
    its annotated fields (dataclasses, NamedTuples, flax modules)."""
    lineage = _lineage(pkg, dotted, name)
    for m, cls in lineage:
        for b in cls.body:
            if isinstance(b, ast.FunctionDef) and b.name == "__init__":
                return keywords(pkg, m.dotted, b)
    fields = set()
    for _m, cls in lineage:
        for b in cls.body:
            if isinstance(b, ast.AnnAssign) and isinstance(b.target,
                                                           ast.Name):
                if "ClassVar" not in ast.unparse(b.annotation):
                    fields.add(b.target.id)
    return fields


def _port(dotted: str) -> str:
    return PORT + dotted[len(JAX):]


def differences() -> list:
    """Every qualname of the JAX surface the port lacks."""
    out = []
    jax_files = {p.relative_to(ROOT / JAX) for pat in SOURCES
                 for p in (ROOT / JAX).rglob(pat)}
    for rel in sorted(jax_files):
        if not (ROOT / PORT / rel).exists():
            out.append(f"{JAX}/{rel.as_posix()}")
    jmods, pmods = package(JAX), package(PORT)
    for dotted, jm in jmods.items():
        pm = pmods.get(_port(dotted))
        if pm is None:
            continue   # reported as a missing file above
        for name in sorted(jm.public - pm.bound):
            out.append(f"{dotted}:{name}")
        for name, fn in jm.funcs.items():
            pfn = pm.funcs.get(name)
            if name.startswith("_") or pfn is None:
                continue
            for kw in sorted(set(_params(fn)) - keywords(PORT, pm.dotted,
                                                         pfn)):
                out.append(f"{dotted}:{name}({kw}=)")
        for cname in jm.classes:
            if cname.startswith("_") and cname not in pm.classes:
                continue
            if _class(PORT, pm.dotted, cname) is None:
                continue
            for kw in sorted(ctor(JAX, dotted, cname)
                             - ctor(PORT, pm.dotted, cname)):
                if not kw.startswith("_"):
                    out.append(f"{dotted}:{cname}({kw}=)")
            if cname.startswith("_"):
                continue
            jms, pms = (methods(JAX, dotted, cname),
                        methods(PORT, pm.dotted, cname))
            for mname, fn in sorted(jms.items()):
                if mname.startswith("_"):
                    continue
                if mname not in pms:
                    out.append(f"{dotted}:{cname}.{mname}")
                    continue
                for kw in sorted(set(_params(fn)) - keywords(
                        PORT, pm.dotted, pms[mname])):
                    out.append(f"{dotted}:{cname}.{mname}({kw}=)")
    return out


def port_has(qualname: str) -> bool:
    """Whether a counterpart, in the same notation, exists in the port."""
    if "/" in qualname:
        return (ROOT / qualname).exists()
    dotted, _, rest = qualname.partition(":")
    m = package(PORT).get(dotted)
    if m is None:
        return False
    head, _, kw = rest.partition("(")
    kw = kw.rstrip("=)")
    if "." in head:
        cname, mname = head.split(".", 1)
        fn = methods(PORT, dotted, cname).get(mname)
        return fn is not None and (not kw or kw in keywords(PORT, dotted, fn))
    if not kw:
        return head in m.bound
    if head in m.funcs:
        return kw in keywords(PORT, dotted, m.funcs[head])
    return _class(PORT, dotted, head) is not None and kw in ctor(
        PORT, dotted, head)


def _allowed(qualname: str) -> bool:
    return any(fnmatch.fnmatchcase(qualname, pat) for pat, _c, _r in ALLOW)


# ------------------------------------------------------------------- tests
def test_port_covers_the_jax_surface():
    missing = [q for q in differences() if not _allowed(q)]
    assert not missing, (
        "the port lacks these names of the JAX package's public surface "
        "(port them, or add an ALLOW entry with its reason):\n  "
        + "\n  ".join(missing))


@pytest.mark.parametrize("entry", ALLOW, ids=[e[0] for e in ALLOW])
def test_allowlist_is_current(entry):
    pattern, counterpart, reason = entry
    assert isinstance(reason, str) and len(reason) > 10, entry
    hits = [q for q in differences() if fnmatch.fnmatchcase(q, pattern)]
    assert hits, (f"stale ALLOW entry {pattern!r}: the JAX name is gone or "
                  "the port now has it; remove the entry")
    for c in ([counterpart] if isinstance(counterpart, str)
              else counterpart or []):
        assert port_has(c), f"{pattern!r}: counterpart {c!r} is missing"


def test_surface_is_parsed():
    """The parse sees the surface: the JAX package's known public names,
    methods and keywords, and the port's counterparts of the names closed
    by hand (deleting one of them fails the coverage test)."""
    jm = package(JAX)
    assert {"init", "run_simulation", "run_async_simulation"} <= \
        jm[JAX].public
    assert "timer" in jm[f"{JAX}.utils.metrics"].public
    assert "any_client_faults" in methods(JAX, f"{JAX}.comm.chaos",
                                          "FaultSpec")
    assert "field_prime" in ctor(JAX, f"{JAX}.comm.codec", "CodecPolicy")
    for q in (f"{PORT}:run_async_simulation",
              f"{PORT}.utils.metrics:percentile_from_snapshots",
              f"{PORT}.utils.metrics:timer",
              f"{PORT}.utils.metrics:MetricsRegistry.reset",
              f"{PORT}.serving.knobs:consumer_knobs",
              f"{PORT}.serving.inference_runner:"
              "FedMLInferenceRunner.metrics_url",
              f"{PORT}.comm.chaos:FaultSpec.any_client_faults",
              f"{PORT}.comm.codec:CodecPolicy(field_prime=)",
              f"{PORT}.comm.message:ARG_ROUND",
              f"{PORT}.native:available",
              f"{PORT}.ops.tree:tree_flatten_to_vector"):
        assert port_has(q), q
    # a `**plugins` passed on to make_round_parts counts its keywords
    rmod = package(PORT)[f"{PORT}.parallel.round"]
    assert "client_dropout" in keywords(PORT, rmod.dotted,
                                        rmod.funcs["build_block_fn"])
