"""FedLLM: federated LoRA fine-tuning of a transformer (port of
examples/fedllm_lora.py; the reference spotlight project,
python/spotlight_prj/fedllm/ — peft LoRA over cross-silo; here adapters
federate through the standard round engine, and the long-context variant
shards sequences over a `seq` mesh axis with ring attention).

Run:  python -m fedml_tpu_torch.examples.fedllm_lora         (flat)
      python -m fedml_tpu_torch.examples.fedllm_lora --ring  (a (silos=2,
          seq=4) mesh of 8 gloo ranks; on one GPU they share it)
      python -m fedml_tpu_torch.examples.fedllm_lora --int8  (QLoRA shape:
          int8 frozen base, per-layer dequant inside the layer loop — the
          7B layout — then served with its adapters)
      each with [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch._device import resolve_device
from fedml_tpu_torch.examples import parser, summed
from fedml_tpu_torch.llm.transformer import ModelDims
from fedml_tpu_torch.ops.tree import tree_map

VOCAB, T, HEADS = 64, 32, 4
DIMS = ModelDims(vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=HEADS,
                 d_ff=128)
N_CLIENTS = 4


def task() -> dict:
    """The clients' sequences: next token = token + 1 (mod VOCAB)."""
    rs = np.random.RandomState(0)
    seqs = (rs.randint(0, VOCAB, (N_CLIENTS, 16, 1))
            + np.arange(T + 1)) % VOCAB
    return {"x": seqs[:, :, :-1], "y": seqs[:, :, 1:],
            "mask": np.ones((N_CLIENTS, 16), np.float32)}


def _given(tree, dev):
    return tree_map(lambda v: torch.as_tensor(v).to(dev), tree)


def ring_rank(draws=None) -> list:
    """One rank of the (silos=2, seq=4) long-context round: 8 rounds over
    the first two clients; the lines to print, every round's loss and the
    rank's kernel launches."""
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import ServerState
    from fedml_tpu_torch.examples import kernel_launches
    from fedml_tpu_torch.llm import (
        TransformerLM, federated_lora, make_fedllm_seq_round,
        shard_fedllm_data,
    )
    from fedml_tpu_torch.llm.transformer import init_params
    from fedml_tpu_torch.parallel.launch import current
    from fedml_tpu_torch.parallel.mesh import make_mesh

    kernel_launches(reset=True)
    dev = current().device
    base = (init_params(DIMS, seed=0, device=dev) if draws is None
            else _given(draws["base"], dev))
    model = TransformerLM.from_state(DIMS, base)
    t = TrainArgs(epochs=1, batch_size=8, learning_rate=0.5)
    _alg, adapters = federated_lora(
        model, base, t, torch.Generator(dev).manual_seed(1), rank=8)
    if draws is not None:
        adapters = _given(draws["adapters"], dev)
    mesh = make_mesh({"silos": 2, "seq": 4})
    rnd = make_fedllm_seq_round(model, base, t, mesh)
    st = ServerState(adapters, None, 0)
    hdata = shard_fedllm_data({k: v[:2] for k, v in task().items()}, mesh,
                              device=dev)
    weights = np.full((2,), 16.0, np.float32)
    lines, losses = [], []
    for r in range(8):
        st, m = rnd(st, hdata, np.arange(2), weights, (2, r),
                    batch_idx=None if draws is None else draws["batches"][r])
        losses.append(float(m["train_loss"]))
        lines.append(f"ring round {r}: loss={losses[-1]:.3f}")
    return [lines, losses, kernel_launches()]


def main(argv=None, draws=None) -> dict:
    """The last round's train_loss, every round's under "losses" (and
    with --int8 the served token count, the tokens under "greedy"; with
    --ring the ranks' summed K1-K4 launches under "rank_launches").
    `draws` (optional): {"base": the f32 base state dict (quantized here
    with --int8), "adapters": the initial adapters, "batches": each
    round's [clients, steps, B] batch order, by round}."""
    ap = parser(__doc__)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.ring:
        from fedml_tpu_torch.parallel.launch import RankPool

        with RankPool([args.device] * 8) as pool:
            outs = pool.run(ring_rank, draws)
        print("\n".join(outs[0][0]))
        return {"train_loss": outs[0][1][-1], "losses": outs[0][1],
                "rank_launches": summed([o[2] for o in outs])}

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.llm import (
        TransformerLM, count_params, federated_lora,
    )
    from fedml_tpu_torch.llm.transformer import init_params
    from fedml_tpu_torch.parallel.round import build_round_fn

    base = (init_params(DIMS, seed=0, device=dev) if draws is None
            else _given(draws["base"], dev))
    model = TransformerLM.from_state(DIMS, base)
    t = TrainArgs(epochs=1, batch_size=8, learning_rate=0.5)
    data = {k: torch.as_tensor(v).to(dev) for k, v in task().items()}
    ids = np.arange(N_CLIENTS)
    weights = np.full((N_CLIENTS,), 16.0, np.float32)
    gen = torch.Generator(dev).manual_seed(1)

    if args.int8:
        # QLoRA shape: int8 frozen base dequantized per layer INSIDE the
        # layer loop (the full-7B single-GPU layout — llm/quant.py)
        from fedml_tpu_torch.algorithms.builtin import make_fedavg
        from fedml_tpu_torch.llm.lora import lora_init
        from fedml_tpu_torch.llm.quant import (
            inscan_model, make_inscan_quant_apply, quant_bytes,
            quantize_tree_int8,
        )

        qbase = quantize_tree_int8(base)
        print(f"int8 base: {quant_bytes(qbase):,} bytes "
              f"(vs {4 * count_params(base):,} f32)")
        inscan = make_inscan_quant_apply(HEADS, dtype=torch.float32)
        qmodel = inscan_model(qbase, HEADS)
        alg = make_fedavg(lambda params, x: inscan(qmodel, params, x), t)
        adapters = lora_init(base, rank=8, generator=gen)
        label = "int8 round"
    else:
        alg, adapters = federated_lora(model, base, t, gen, rank=8)
        label = "round"
    if draws is not None:
        adapters = _given(draws["adapters"], dev)

    print(f"adapter payload: {count_params(adapters):,} params "
          f"({count_params(adapters) / count_params(base):.2%} of base)")
    rnd = build_round_fn(alg, mesh=None)
    st = alg.server_init(adapters, None)
    losses = []
    for r in range(8):
        out = rnd(st, None, data, ids, weights, (2, r), batch_idx=None
                  if draws is None else _given(draws["batches"][r], dev))
        st = out.server_state
        losses.append(float(out.metrics["train_loss"]))
        print(f"{label} {r}: loss={losses[-1]:.3f}")
    result = {"train_loss": losses[-1], "losses": losses}

    if args.int8:
        # serve the federated result DIRECTLY in its QLoRA layout: int8
        # frozen base + the trained adapters, KV-cache decode, greedy then
        # sampled (serving/predictor.py + llm/decode.py)
        from fedml_tpu_torch.serving import GreedyLMPredictor

        pred = GreedyLMPredictor(TransformerLM.from_state(DIMS, qbase),
                                 max_len=64, kv_cache=True,
                                 adapters=st.params, device=dev)
        prompt = task()["x"][0, 0, :8].astype(int).tolist()
        greedy = pred.predict({"tokens": prompt, "max_new_tokens": 8})
        sampled = pred.predict({"tokens": prompt, "max_new_tokens": 8,
                                "temperature": 0.8, "top_k": 8, "seed": 0})
        print("served greedy:", greedy["generated_tokens"])
        print("served sampled:", sampled["generated_tokens"])
        assert len(greedy["generated_tokens"]) == 8
        result["served"] = len(greedy["generated_tokens"]) + len(
            sampled["generated_tokens"])
        result["greedy"] = greedy["generated_tokens"]
    print("OK fedllm lora")
    return result


if __name__ == "__main__":
    main()
