"""whisper-tiny (the encoder-decoder) in the port against the reference.

The analogue of the whisper cases of the reference's `tests/test_archs.py`
(exact config, param count, smoke forward) and of
`tests/test_serve.py::test_prefill_decode_matches_forward[whisper-tiny]`, on
the smoke config with the reference's seed-0 weights bridged into the port
and numpy-seeded inputs.

Tolerances, as max |port - ref| / max |ref|: one layer, fp32 1e-6 (a few ops
each side, rounding-level) and bf16 8e-3 (two bf16 ulps: XLA on the CPU keeps
some elementwise chains in fp32 where PyTorch rounds each op to bf16); a
whole model, fp32 2e-5 and bf16 0.02 (the decoder-only tests' limits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import batch_pair, model_pair, randn, rel_err, to_np
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import api as jax_api
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import ShapeSpec, get_config, smoke_config
from repro_torch.models import api, encdec
from repro_torch.models import attention as A
from repro_torch.models import layers as L

ARCH = "whisper-tiny"
LAYER_TOL = {"float32": 1e-6, "bfloat16": 8e-3}
MODEL_TOL = {"float32": 2e-5, "bfloat16": 0.02}
DTYPES = ["float32", "bfloat16"]


def _layer0(jp, name):
    return jax.tree.map(lambda a: a[0], jp["layers"][name])


@pytest.mark.parametrize("smoke", [True, False])
def test_config_is_a_field_for_field_copy(smoke):
    cfg, jcfg = get_config(ARCH), JAX_ARCHS[ARCH]
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = get_config(ARCH)
    assert (full.num_layers, full.encoder_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.d_ff, full.vocab_size, full.source_len) == (
        4, 4, 384, 6, 6, 1536, 51865, 1500)
    assert (full.norm, full.act, full.glu, full.rope, full.tie_embeddings) == (
        "layernorm", "gelu", False, "learned", True)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_reference(smoke):
    cfg, jcfg = get_config(ARCH), JAX_ARCHS[ARCH]
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    assert api.param_count(cfg) == jax_api.param_count(jcfg)
    assert api.flops_param_count(cfg) == jax_api.flops_param_count(jcfg)
    if not smoke:
        # as tests/test_archs.py counts it: the position table is sized for
        # decode_32k, real whisper has 448 target positions
        got = api.param_count(cfg) - (cfg.max_positions - 448) * cfg.d_model
        assert abs(got - 37e6) / 37e6 < 0.25, got


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    cfg = smoke_config(get_config(ARCH)).replace(compute_dtype=dtype)
    jcfg = jax_smoke(JAX_ARCHS[ARCH]).replace(compute_dtype=dtype)
    rng = np.random.default_rng(0)
    x, xn = randn(rng, (2, 8, cfg.d_model), dtype)
    x, xn = x + 0.5, xn + 0.5               # a mean away from 0: var = E[x^2] - mu^2
    scale, scale_n = randn(rng, (cfg.d_model,), "float32")
    bias, bias_n = randn(rng, (cfg.d_model,), "float32")
    out = L.apply_norm(cfg, {"scale": scale, "bias": bias}, x)
    ref = JL.apply_norm(jcfg, {"scale": jnp.asarray(scale_n), "bias": jnp.asarray(bias_n)},
                        jnp.asarray(xn, dtype))
    assert out.dtype == x.dtype
    assert rel_err(to_np(out), ref) < LAYER_TOL[dtype]
    assert set(L.norm_meta(cfg)) == {"scale", "bias"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    assert set(p["layers"][0]["mlp"]) == {"w_up", "w_down"}
    x, xn = randn(np.random.default_rng(1), (2, 8, cfg.d_model), dtype)
    out = L.apply_mlp(cfg, p["layers"][0]["mlp"], x)
    ref = JL.apply_mlp(jcfg, _layer0(jp, "mlp"), jnp.asarray(xn, dtype))
    assert rel_err(to_np(out), ref) < LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_learned_positions_and_tied_head_match_reference(dtype):
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    assert "out_head" not in p["embed"]
    assert p["embed"]["pos_table"].shape == (cfg.source_len + cfg.max_positions, cfg.d_model)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    pos = rng.integers(0, cfg.source_len + cfg.max_positions, (2, 8))
    x = L.embed_tokens(cfg, p["embed"], torch.from_numpy(tokens), torch.from_numpy(pos))
    jx = JL.embed_tokens(jcfg, jp["embed"], jnp.asarray(tokens, jnp.int32),
                         positions=jnp.asarray(pos, jnp.int32))
    # two gathers and one add in the compute dtype on both sides: equal bits
    np.testing.assert_array_equal(to_np(x), np.asarray(jx, np.float32))
    logits = L.logits_head(cfg, p["embed"], x)
    assert rel_err(to_np(logits), JL.logits_head(jcfg, jp["embed"], jx)) < LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_and_cross_attention_match_reference(dtype):
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    batch, jbatch = batch_pair(cfg, 2, 8)
    memory = encdec.encode(cfg, p, batch["frame_embeds"])
    jmemory = JE.encode(jcfg, jp, jbatch["frame_embeds"])
    assert memory.shape == (2, cfg.source_len, cfg.d_model)
    assert rel_err(to_np(memory), jmemory) < MODEL_TOL[dtype]
    # one cross-attention on the reference's memory, so only the layer differs
    mem = torch.from_numpy(np.array(jmemory, np.float32)).to(memory.dtype)
    x, xn = randn(np.random.default_rng(3), (2, 8, cfg.d_model), dtype)
    kv = A.encode_memory_kv(cfg, p["layers"][0]["cross"], mem)
    out = A.apply_cross_attention(cfg, p["layers"][0]["cross"], x, kv)
    jcross = _layer0(jp, "cross")
    ref = JA.apply_cross_attention(jcfg, jcross, jnp.asarray(xn, dtype),
                                   JA.encode_memory_kv(jcfg, jcross, jmemory))
    assert rel_err(to_np(out), ref) < LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    batch, jbatch = batch_pair(cfg, 2, 16)
    logits, aux = api.forward(cfg, p, batch, attn_impl="flash")   # ignored, as in the reference
    jlogits, _ = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    assert logits.shape == (2, 16, cfg.vocab_size) and float(aux) == 0.0
    assert np.isfinite(to_np(logits)).all()
    assert rel_err(to_np(logits), jlogits) < MODEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_decode_matches_forward(dtype):
    """The analogue of tests/test_serve.py::test_prefill_decode_matches_forward
    [whisper-tiny]: prefill 15 tokens with cache_len 16, decode the 16th; its
    logits against the forward's last, and against the reference's own decode."""
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    B, S = 2, 16
    batch, jbatch = batch_pair(cfg, B, S)
    full, _ = api.forward(cfg, p, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = api.prefill(cfg, p, pre, cache_len=S)
    dec, same = api.decode_step(cfg, p, cache, batch["tokens"][:, -1:], S - 1)
    assert same is cache
    assert rel_err(to_np(dec[:, 0]), to_np(full[:, -1])) < MODEL_TOL[dtype]
    jpre = dict(jbatch, tokens=jbatch["tokens"][:, :-1])
    _, jcache = jax_api.prefill(jcfg, jp, jpre, cache_len=S)
    jdec, _ = jax_api.decode_step(jcfg, jp, jcache, jbatch["tokens"][:, -1:], jnp.int32(S - 1))
    assert rel_err(to_np(dec), jdec) < MODEL_TOL[dtype]


def test_multi_step_decode_matches_forward():
    """Four decode steps after a 12-token prefill, each against the forward's
    logits at its position (fp32)."""
    cfg, _, _, p = model_pair(ARCH, "float32")
    batch, _ = batch_pair(cfg, 2, 16, seed=3)
    full, _ = api.forward(cfg, p, batch)
    _, cache = api.prefill(cfg, p, dict(batch, tokens=batch["tokens"][:, :12]), cache_len=16)
    for pos in range(12, 16):
        lg, cache = api.decode_step(cfg, p, cache, batch["tokens"][:, pos:pos + 1], pos)
        assert rel_err(to_np(lg[:, 0]), to_np(full[:, pos])) < MODEL_TOL["float32"]


def test_cache_layout_pads_only_self_kv():
    """One {k, v, cross_k, cross_v} per decoder layer: k and v padded to cache_len
    as api.cache_specs says, the cross K/V at the encoder's length and equal to
    the memory's projection."""
    cfg, _, _, p = model_pair(ARCH, "float32")
    batch, _ = batch_pair(cfg, 2, 8)
    _, cache = api.prefill(cfg, p, batch, cache_len=20)
    specs = api.cache_specs(cfg, ShapeSpec("t", "decode", 20, 2), dtype=torch.float32)
    assert isinstance(cache, list) and len(cache) == cfg.num_layers
    assert [{k: (tuple(a.shape), a.dtype) for k, a in e.items()} for e in cache] == \
        [{k: (s.shape, s.dtype) for k, s in e.items()} for e in specs]
    assert not cache[0]["k"][:, 8:].any() and cache[0]["k"][:, :8].any()
    memory = encdec.encode(cfg, p, batch["frame_embeds"])
    k, v = A.encode_memory_kv(cfg, p["layers"][1]["cross"], memory)
    assert torch.equal(cache[1]["cross_k"], k) and torch.equal(cache[1]["cross_v"], v)


def test_bridge_round_trip_is_exact():
    jcfg = jax_smoke(JAX_ARCHS[ARCH])
    np_tree = jax.tree.map(np.array, jax_api.init_params(jcfg, 0))
    cfg = smoke_config(get_config(ARCH))
    port = params_from_jax(np_tree, cfg, device="cpu", dtype=torch.float32)
    assert len(port["enc_layers"]) == cfg.encoder_layers and "cross" in port["layers"][0]
    back = params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        np.testing.assert_array_equal(a, b)


def test_serving_drivers_refuse_the_encoder_decoder():
    """As the reference's serve driver does: whisper serves through api.prefill
    and api.decode_step only."""
    from repro_torch.launch.serve import BatchedServer, SERVABLE
    cfg = smoke_config(get_config(ARCH))
    assert ARCH not in SERVABLE and "chatglm3-6b" in SERVABLE
    with pytest.raises(NotImplementedError, match="decoder-only"):
        BatchedServer(cfg, api.init_params(cfg, 0, device="cpu"))
