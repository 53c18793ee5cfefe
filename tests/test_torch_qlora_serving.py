"""Serving over an int8 LoRA base (the QLoRA serving layout) in the port
against the JAX package.

The setting is tests/test_kv_decode.py's `_setup(True, True)`: vocab 96,
d_model 64, 3 layers, 4 heads, d_ff 128, a 10-token prompt, the JAX base
quantised by `quantize_tree_int8` and rank-4 adapters (std 0.3 plus
0.05), carried into the port's layout by `params_from_flax` /
`adapters_from_jax`.

Bars (token identity, the JAX tests' own bar for greedy decode):
- `GreedyLMPredictor(kv_cache=True, adapters=)` over the int8 base gives
  JAX's predictor's 6 tokens (both decode in the base's bf16) and JAX's
  f32 in-scan recompute loop's; without kv_cache it refuses adapters with
  JAX's message;
- the paged `DecodeEngine` (`paged_kernel=True`: K4's plain version on
  the CPU) over the int8 base with the adapters, in f32, gives the port's
  f32 recompute loop's tokens (`make_inscan_quant_apply`), and so does
  the predictor's engine route; without adapters too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.quant import make_inscan_quant_apply as jax_inscan
from fedml_tpu.llm.quant import quantize_tree_int8 as jax_quantize
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.serving.predictor import GreedyLMPredictor as JaxLM
from fedml_tpu_torch.llm import quant
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.serving.engine import DecodeEngine
from fedml_tpu_torch.serving.predictor import GreedyLMPredictor

torch.set_num_threads(2)

V, D, L, H, FF, TP = 96, 64, 3, 4, 128, 10
MAXLEN, N_NEW = 24, 6
DIMS = ModelDims(V, D, L, H, FF)


@pytest.fixture(scope="module")
def setup():
    model = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                   scan_layers=True)
    base = model.init(jax.random.key(0),
                      jnp.zeros((1, TP), jnp.int32))["params"]
    ads = jax_lora_init(jax.random.key(1), base, rank=4, a_std=0.3)
    ads = jax.tree.map(lambda a: a + 0.05 * jnp.ones_like(a), ads)
    qparams = jax_quantize(base)
    toks = np.random.RandomState(0).randint(1, V, (1, TP))
    qstate = params_from_flax(jax.tree.map(np.asarray, qparams),
                              dtype=torch.bfloat16, device="cpu")
    t_ads = adapters_from_jax(jax.tree.map(np.asarray, ads), device="cpu")
    return model, qparams, ads, toks, qstate, t_ads


def _port_recompute(qstate, ads, prompt, n_new, dtype):
    """The port's greedy loop over the in-scan recompute forward."""
    apply = quant.make_inscan_quant_apply(H, dtype=dtype)
    model = quant.inscan_model(qstate, H, remat=False)
    buf = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits = apply(model, ads, torch.tensor([buf]))
            buf.append(int(logits[0, -1].float().argmax()))
    return buf[len(prompt):]


def test_predictor_matches_jax_qlora_predictor(setup):
    model_j, qparams, ads, toks, qstate, t_ads = setup
    req = {"tokens": toks[0].tolist(), "max_new_tokens": N_NEW}
    want = JaxLM(model_j, qparams, max_len=MAXLEN, kv_cache=True,
                 adapters=ads).predict(req)["generated_tokens"]
    model = TransformerLM.from_state(DIMS, qstate)
    assert model.dtype == torch.bfloat16
    assert isinstance(model.blocks[0].wq.kernel, quant.QWeight)
    pred = GreedyLMPredictor(model, max_len=MAXLEN, kv_cache=True,
                             adapters=t_ads, device="cpu")
    assert pred.predict(req)["generated_tokens"] == want
    # JAX's f32 in-scan recompute loop (tests/test_kv_decode.py's
    # reference) gives the same tokens
    j_apply = jax.jit(jax_inscan(H, dtype=jnp.float32))
    buf = toks[0].tolist()
    for _ in range(N_NEW):
        lg = j_apply(qparams, ads, jnp.asarray([buf]))
        buf.append(int(jnp.argmax(lg[0, -1])))
    assert buf[TP:] == want
    with pytest.raises(ValueError, match="need kv_cache=True"):
        GreedyLMPredictor(model, max_len=MAXLEN, adapters=t_ads,
                          device="cpu")


@pytest.mark.parametrize("adapters", [True, False])
def test_engine_over_int8_base_matches_recompute(setup, adapters):
    _m, _q, _a, toks, qstate, t_ads = setup
    ads = t_ads if adapters else None
    model = TransformerLM.from_state(DIMS, qstate)
    prompts = [toks[0].tolist(), toks[0, :6].tolist() + [5, 7, 9]]
    want = [_port_recompute(qstate, ads, p, N_NEW, torch.float32)
            for p in prompts]
    eng = DecodeEngine(model, ads, n_slots=2, max_len=MAXLEN, page_size=4,
                       prefill_chunk=4, paged_kernel=True,
                       dtype=torch.float32, device="cpu").start()
    try:
        got = [t.result(timeout=120) for t in
               [eng.submit(p, N_NEW) for p in prompts]]
    finally:
        eng.stop()
    assert got == want
    # the adapted kernels are merged once, dense in the compute dtype;
    # the rest of the base stays int8
    serving = eng.serving_model
    assert isinstance(serving.blocks[0].w_up.kernel, quant.QWeight)
    assert isinstance(serving.blocks[0].wq.kernel, torch.Tensor) == adapters
    if adapters:
        assert serving.blocks[0].wq.kernel.dtype == torch.float32
    pred = GreedyLMPredictor(model, max_len=MAXLEN, kv_cache=True,
                             adapters=ads, compute_dtype="float32",
                             decode_slots=2, kv_page_size=4,
                             paged_kernel=True, device="cpu")
    try:
        out = pred.predict({"tokens": prompts[0], "max_new_tokens": N_NEW})
    finally:
        pred.stop()
    assert out["generated_tokens"] == want[0]
