"""Rank halves of `test_torch_seq.py`: functions a gloo `RankPool` runs in
every rank. Torch and the port only, so the ranks never load JAX; inputs
and results are host numpy."""
import numpy as np
import torch

from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.core.algorithm import ServerState
from fedml_tpu_torch.llm import make_fedllm_seq_round, shard_fedllm_data
from fedml_tpu_torch.llm import quant
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.parallel import mesh as mesh_mod
from fedml_tpu_torch.parallel import seq
from fedml_tpu_torch.parallel.launch import current

_MESHES: dict = {}


def mesh(*axes):
    """The mesh {name: size for (name, size) in axes}, made once per
    process (every rank builds it in the same order)."""
    if axes not in _MESHES:
        _MESHES[axes] = mesh_mod.make_mesh(dict(axes))
    return _MESHES[axes]


def attention(kind: str, q, k, v, w):
    """This rank's chunk of ring / Ulysses attention over a seq-4 mesh of
    the whole [B, T, H, D] inputs, and the chunk's gradients of
    sum(out * w): (out, dq, dk, dv) for the rank's tokens."""
    m = mesh(("seq", 4))
    i, n = mesh_mod.axis_index(m, "seq"), 4
    t = q.shape[1] // n
    chunk = slice(i * t, (i + 1) * t)
    qc, kc, vc = (torch.from_numpy(np.ascontiguousarray(a[:, chunk]))
                  .requires_grad_() for a in (q, k, v))
    fn = seq.ring_attention if kind == "ring" else seq.ulysses_attention
    out = fn(qc, kc, vc, m, "seq")
    grads = torch.autograd.grad(
        (out * torch.from_numpy(np.ascontiguousarray(w[:, chunk]))).sum(),
        (qc, kc, vc))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def seq_round(spec: dict):
    """`spec["rounds"]` rounds of make_fedllm_seq_round over the mesh
    `spec["axes"]` from the JAX initial adapters and batch schedules;
    the trained adapters and metrics (None in a rank the mesh leaves
    out)."""
    m = mesh(*spec["axes"])
    if not mesh_mod.in_mesh(m):
        return None
    dims = ModelDims(**spec["dims"])
    if spec.get("quant"):
        base = params_from_flax(spec["base"], dtype=torch.bfloat16,
                                device="cpu")
    else:
        base = params_from_flax(spec["base"], device="cpu")
    model = TransformerLM.from_state(dims, base)
    t = TrainArgs(**spec["train"])
    rnd = make_fedllm_seq_round(model, base, t, m, attn=spec["attn"],
                                inscan_quant=bool(spec.get("quant")))
    data = shard_fedllm_data(spec["data"], m, device="cpu")
    st = ServerState(adapters_from_jax(spec["adapters"], device="cpu"),
                     None, 0)
    mets = []
    for r, sched in enumerate(spec["schedules"]):
        st, met = rnd(st, data, spec["ids"], spec["weights"], seed=r,
                      batch_idx=sched)
        mets.append({k: float(v) for k, v in met.items()})
    return {"rank": current().rank,
            "params": {k: {n: v.numpy() for n, v in ab.items()}
                       for k, ab in st.params.items()},
            "metrics": mets}


def errors(base_np: dict, dims: dict):
    """The messages of make_fedllm_seq_round's refusals on a
    (silos 1, seq 4) mesh."""
    m = mesh(("silos", 1), ("seq", 4))
    base = params_from_flax(base_np, device="cpu")
    model = TransformerLM.from_state(ModelDims(**dims), base)
    t = TrainArgs()
    out = {}
    for name, kw, b in (
            ("attn", {"attn": "flash"}, base),
            ("ulysses", {"attn": "ulysses"}, base),
            ("float_base", {"inscan_quant": True}, base),
            ("layout", {"inscan_quant": True}, {"block_0": {}})):
        try:
            make_fedllm_seq_round(model, b, t, m, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["is_q"] = any(quant.is_q(v) for v in base.values())
    return out
