"""Rank halves of the port's tensor-parallel tests (`test_torch_tp.py`,
`test_torch_scale.py`, `test_torch_engine_tp.py`,
`test_torch_centralized_mp.py`): functions a gloo `RankPool` runs in
every rank. Torch and the port only, so the ranks never load JAX; inputs
and results are host numpy (a state dict may hold {"q", "s"} dicts)."""
import numpy as np
import torch

from fedml_tpu_torch.llm import tp as tp_mod
from fedml_tpu_torch.llm.quant import flat_state
from fedml_tpu_torch.llm.transformer import ModelDims, TransformerLM
from fedml_tpu_torch.parallel import mesh as mesh_mod
from fedml_tpu_torch.parallel import partition

_MESHES: dict = {}


def mesh(*axes):
    """The mesh {name: size for (name, size) in axes}, made once per
    process (every rank builds it in the same order)."""
    if axes not in _MESHES:
        _MESHES[axes] = mesh_mod.make_mesh(dict(axes))
    return _MESHES[axes]


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def tp_forward(spec: dict):
    """The global logits of `spec["tokens"]` through the rank's shard of
    `spec["state"]` over the mesh `spec["axes"]` (tp axis "tp"), with
    `spec["adapters"]` when given, in f32 (an int8 base dequantised)."""
    m = mesh(*spec["axes"])
    if not mesh_mod.in_mesh(m):
        return None
    dims = ModelDims(**spec["dims"])
    shard = tp_mod.shard_params_tp(_t(spec["state"]), m)
    toks = _t(spec["tokens"]).long()
    ads = spec.get("adapters")
    if ads is None:
        out = tp_mod.make_tp_forward(dims, m)(shard, toks)
    else:
        model = tp_mod.tp_model(dims, shard, m)
        out = model(toks, adapters=_t(ads), dtype=torch.float32)
    return _np(out)


def tp_train(spec: dict):
    """`spec["steps"]` TP train steps; (losses, the whole trained state
    gathered back)."""
    m = mesh(*spec["axes"])
    if not mesh_mod.in_mesh(m):
        return None
    dims = ModelDims(**spec["dims"])
    state = _t(spec["state"])
    specs = tp_mod.tp_param_specs(state)
    shard = tp_mod.shard_params_tp(state, m)
    step = tp_mod.make_tp_train_step(dims, m, lr=spec["lr"])
    x, y = _t(spec["x"]).long(), _t(spec["y"]).long()
    losses = []
    for _ in range(spec["steps"]):
        shard, loss = step(shard, x, y)
        losses.append(float(loss))
    return losses, _np(partition.unshard_params(shard, m, specs))


def scaled(spec: dict):
    """`build_scaled_fedllm` over the mesh `spec["axes"]` from the injected
    base and adapters: the losses of `spec["steps"]` steps, the trained
    adapters and the rank's base bytes."""
    from fedml_tpu_torch.llm.quant import quant_bytes
    from fedml_tpu_torch.llm.scale import build_scaled_fedllm

    m = mesh(*spec["axes"])
    if not mesh_mod.in_mesh(m):
        return None
    d = spec["dims"]
    _model, base, ads, step = build_scaled_fedllm(
        TransformerLM, m, rank=4, lr=spec["lr"],
        compute_dtype="float32", quantize_base=spec.get("quant", False),
        scan_layers=spec.get("scan", False),
        seq_axis="seq" if "seq" in dict(spec["axes"]) else None,
        dp_axis=spec.get("dp_axis", "dp"), base=_t(spec["base"]), adapters=_t(spec["adapters"]),
        device="cpu", **d)
    x, y = _t(spec["x"]).long(), _t(spec["y"]).long()
    losses = []
    for _ in range(spec["steps"]):
        ads, loss = step(ads, x, y)
        losses.append(float(loss))
    return {"losses": losses, "adapters": _np(ads),
            "base_bytes": quant_bytes(base)}


def checkpoint(spec: dict):
    """A sharded base written and read back on the mesh `spec["axes"]`
    (float or int8, drawn into its layout), bit for bit; then the
    refusal of the same files on `spec["other_axes"]`."""
    from fedml_tpu_torch.llm.scale import (
        init_base_shard, restore_base_sharded, save_base_sharded,
    )

    m = mesh(*spec["axes"])
    dims = ModelDims(**spec["dims"])
    base = init_base_shard(dims, m, "tp", seed=3, quantize=spec["quant"],
                           dtype=torch.float32, device="cpu")
    save_base_sharded(spec["path"], base, m)
    got = restore_base_sharded(spec["path"], base, m, device="cpu")
    fb, fg = flat_state(base), flat_state(got)
    same = fb.keys() == fg.keys() and all(
        torch.equal(fb[k], fg[k]) and fb[k].dtype == fg[k].dtype
        for k in fb)
    other = mesh(*spec["other_axes"])
    err = None
    if mesh_mod.in_mesh(other):
        try:
            restore_base_sharded(spec["path"], base, other, device="cpu")
        except ValueError as e:
            err = str(e)
    full = {k: tuple(v.shape) for k, v in fb.items()}
    return {"same": same, "refusal": err, "shapes": full}


def engine(spec: dict):
    """Requests through a DecodeEngine of the whole `spec["state"]` over
    the mesh `spec["axes"]` (None: unmeshed, in rank 0 only), with
    `spec["kw"]` knobs; with `spec["swap"]`, a first batch of requests on
    the adapters, a hot swap, then a second batch. The leader returns the
    token lists of every batch (and its engine's K4 launches by H),
    followers None."""
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.parallel.launch import current
    from fedml_tpu_torch.serving.engine import DecodeEngine

    dims = ModelDims(**spec["dims"])
    state = _t(spec["state"])
    model = TransformerLM.from_state(dims, state)
    m = mesh(*spec["axes"]) if spec["axes"] else None
    if m is None and current().rank != 0:
        return None
    if m is not None and not mesh_mod.in_mesh(m):
        return None
    ads = _t(spec["adapters"]) if spec.get("adapters") else None
    with pa._count_lock:
        pa.launches_by_h.clear()
    eng = DecodeEngine(model, ads, n_slots=2, max_len=spec["max_len"],
                       mesh=m, device="cpu", **spec.get("kw", {})).start()
    if not eng._leader:
        eng.stop()
        return None
    out = []
    batches = [spec["requests"]] + ([spec["requests"]] if spec.get("swap")
                                    else [])
    try:
        for i, reqs in enumerate(batches):
            if i:
                eng.swap_adapters(_t(spec["swap"]))
            ts = [eng.submit(p, b) for p, b in reqs]
            out.append([t.result(timeout=120) for t in ts])
    finally:
        eng.stop()
    return {"tokens": out, "by_h": dict(pa.launches_by_h),
            "version": eng.model_version,
            "specs": {k: tuple(v) for k, v in eng.param_specs.items()}
            if eng.param_specs else None}


def engine_refusals(spec: dict):
    """The tensor-parallel engine's refusals, as this rank raises them."""
    from fedml_tpu_torch.serving.engine import DecodeEngine

    out = {}
    dims = ModelDims(**spec["dims"])
    model = TransformerLM.from_state(dims, _t(spec["state"]))
    for key, axes, mdl in (("axis", (("dp", 2),), model),
                           ("divisible", (("mp", 2),), TransformerLM.from_state(
                               ModelDims(**spec["odd_dims"]),
                               _t(spec["odd_state"])))):
        try:
            DecodeEngine(mdl, n_slots=1, max_len=16, mesh=mesh(*axes),
                         device="cpu")
        except ValueError as e:
            out[key] = str(e)
    try:
        partition.shard_params(_t(spec["state"]), mesh(("dp", 2)),
                               "transformer_lm")
    except partition.PartitionRuleError as e:
        out["shard"] = str(e)
    return out


def predictor(spec: dict):
    """`lm_predictor_from_serve_knobs` with `spec["serve"]` in every rank;
    the leader's prediction of one prompt (followers None) and the
    engine's mp size."""
    from fedml_tpu_torch.config import Config
    from fedml_tpu_torch.serving.predictor import (
        lm_predictor_from_serve_knobs,
    )

    dims = ModelDims(**spec["dims"])
    model = TransformerLM.from_state(dims, _t(spec["state"]))
    cfg = Config.from_dict({"serve": spec["serve"]})
    pred = lm_predictor_from_serve_knobs(cfg.serve_args.extra, model,
                                         device="cpu")
    try:
        mp = mesh_mod.axis_size(pred.engine.mesh, "mp")
        if not pred.engine._leader:
            return None
        out = pred.predict({"tokens": spec["prompt"],
                            "max_new_tokens": spec["new"]})
        return {"mp": mp, "out": out}
    finally:
        pred.stop()


def centralized(spec: dict):
    """A CentralizedTrainer over `spec["config"]` (its device_args mesh)
    from the given initial params and batch orders; the rank's
    history, its whole trained params gathered back, and its specs."""
    import fedml_tpu_torch
    from fedml_tpu_torch.centralized import CentralizedTrainer

    cfg = fedml_tpu_torch.init(config=spec["config"], device="cpu")
    tr = CentralizedTrainer(cfg, params=_t(spec["params"]), device="cpu")
    hist = tr.run(epochs=len(spec["idx"]), batch_idx=spec["idx"])
    params = (partition.unshard_params(tr.params, tr.mesh, tr.param_specs)
              if tr.mesh is not None else tr.params)
    local = {k: tuple(v.shape) for k, v in tr.params.items()}
    return {"hist": hist, "params": _np(params), "local": local,
            "specs": {k: tuple(v) for k, v in tr.param_specs.items()}
            if tr.param_specs else None}


def split_rnn_grad(spec: dict):
    """The LSTM LM (`hub.create("rnn")`) with its params resolved under
    `mlp_cnn` (unmatched replicated) over {"mp": 2}, its split layers
    marked (`hub.split_layers`): the rank's next-token CE on `spec`'s
    tokens, the whole gradient gathered back, the specs and the rank's
    local shapes."""
    import torch.nn.functional as F

    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.tensor import TPContext

    m = mesh(("mp", 2))
    params = _t(spec["params"])
    model = hub.create("rnn", spec["vocab"], spec["x"].shape[1:],
                       device="cpu")
    specs = partition.resolve("mlp_cnn", params, on_unmatched="replicated")
    local = {k: v.requires_grad_() for k, v in partition.shard_params(
        params, m, "mlp_cnn", specs=specs).items()}
    logits = hub.apply_fn(hub.split_layers(model, specs,
                                           TPContext(m, "mp")))(
        local, _t(spec["x"]))
    loss = F.cross_entropy(logits.flatten(0, 1), _t(spec["y"]).flatten())
    grads = dict(zip(local, torch.autograd.grad(loss, list(local.values()))))
    return {"loss": float(loss.detach()),
            "grads": _np(partition.unshard_params(grads, m, specs)),
            "specs": {k: tuple(v) for k, v in specs.items()},
            "local": {k: tuple(v.shape) for k, v in local.items()}}


def scale_errors(spec: dict):
    """`make_ring_attn_fn`'s and `build_scaled_fedllm`'s refusals on the
    mesh `spec["axes"]`, as this rank raises them."""
    from fedml_tpu_torch.llm.scale import build_scaled_fedllm, make_ring_attn_fn

    m = mesh(*spec["axes"])
    if not mesh_mod.in_mesh(m):
        return None
    out = {}
    for key, kw in spec["ring"].items():
        try:
            make_ring_attn_fn(m, **kw)
        except ValueError as e:
            out[key] = str(e)
    try:
        build_scaled_fedllm(TransformerLM, m, scan_layers=True,
                            quantize_base=False, device="cpu",
                            **spec["dims"])
    except ValueError as e:
        out["scan"] = str(e)
    return out
