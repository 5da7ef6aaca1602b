"""Port layers, configs, init and weight bridge vs the reference, on smoke chatglm3-6b.

Inputs are numpy-seeded and fed to both packages.  Tolerances, as max
|port - ref| / max |ref|: fp32 1e-6 (one op each side, rounding-level);
bf16 8e-3, two bf16 ulps (2**-7): XLA on the CPU keeps some elementwise
chains in fp32 where PyTorch rounds each op to bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randn, rel_err, to_np
from repro.configs import ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import api as jax_api
from repro.models import layers as JL
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import api
from repro_torch.models import layers as L

TOL = {"float32": 1e-6, "bfloat16": 8e-3}
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype):
    return (smoke_config(get_config("chatglm3-6b")).replace(compute_dtype=dtype),
            jax_smoke(ARCHS["chatglm3-6b"]).replace(compute_dtype=dtype))


def _params(dtype):
    cfg, jcfg = _cfgs(dtype)
    jp = jax_api.init_params(jcfg, 0)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")


def test_configs_are_field_for_field_copies():
    full = get_config("chatglm3-6b")
    assert dataclasses.asdict(full) == dataclasses.asdict(ARCHS["chatglm3-6b"])
    assert dataclasses.asdict(smoke_config(full)) == dataclasses.asdict(
        jax_smoke(ARCHS["chatglm3-6b"]))
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.rope_fraction) == (
        28, 4096, 32, 2, 128, 13696, 65024, 0.5)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_reference(smoke):
    cfg, jcfg = get_config("chatglm3-6b"), ARCHS["chatglm3-6b"]
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    assert api.param_count(cfg) == jax_api.param_count(jcfg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_reference(dtype):
    cfg, jcfg, jp, p = _params(dtype)
    rng = np.random.default_rng(0)
    x, xn = randn(rng, (2, 8, cfg.d_model), dtype)
    scale, scale_n = randn(rng, (cfg.d_model,), "float32")
    out = L.apply_norm(cfg, {"scale": scale}, x)
    ref = JL.apply_norm(jcfg, {"scale": jnp.asarray(scale_n)}, jnp.asarray(xn, dtype))
    assert out.dtype == x.dtype
    assert rel_err(to_np(out), ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_partial_rope_matches_reference(dtype):
    cfg, jcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    x, xn = randn(rng, (2, 12, cfg.num_heads, cfg.head_dim), dtype)
    pos = np.broadcast_to(np.arange(3, 15), (2, 12)).copy()
    out = L.apply_rope(cfg, x, torch.from_numpy(pos))
    ref = JL.apply_rope(jcfg, jnp.asarray(xn, dtype), jnp.asarray(pos, jnp.int32))
    assert rel_err(to_np(out), ref) < TOL[dtype]
    # half-split rotation of the first rope_fraction of head_dim only
    rot = int(cfg.head_dim * cfg.rope_fraction)
    assert torch.equal(out[..., rot:], x[..., rot:])


def test_learned_rope_leaves_x_as_the_reference_does():
    """rope="learned" embeds positions instead of rotating: both packages' apply_rope
    return x as it is."""
    cfg = get_config("chatglm3-6b").replace(rope="learned")
    jcfg = ARCHS["chatglm3-6b"].replace(rope="learned")
    rng = np.random.default_rng(7)
    x, xn = randn(rng, (2, 12, 4, cfg.head_dim), "float32")
    pos = rng.integers(0, 64, (2, 12))
    out = L.apply_rope(cfg, x, torch.from_numpy(pos))
    ref = JL.apply_rope(jcfg, jnp.asarray(xn), jnp.asarray(pos, jnp.int32))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    assert torch.equal(out, x)


def test_standard_rope_is_a_rotation():
    cfg = _cfgs("float32")[0].replace(rope="standard", rope_fraction=1.0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, 4, 16)).astype(np.float32))
    y = L.apply_rope(cfg, x, torch.arange(8)[None].expand(2, 8))
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1), rtol=1e-5, atol=0)
    assert torch.equal(L.apply_rope(cfg, x, torch.zeros(2, 8, dtype=torch.long)), x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_matches_reference(dtype):
    cfg, jcfg, jp, p = _params(dtype)
    x, xn = randn(np.random.default_rng(3), (2, 8, cfg.d_model), dtype)
    out = L.apply_mlp(cfg, p["layers"][1]["mlp"], x)
    jmlp = jax.tree.map(lambda a: a[1], jp["layers"]["mlp"])
    ref = JL.apply_mlp(jcfg, jmlp, jnp.asarray(xn, dtype))
    assert rel_err(to_np(out), ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_logits_match_reference(dtype):
    cfg, jcfg, jp, p = _params(dtype)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8))
    x = L.embed_tokens(cfg, p["embed"], torch.from_numpy(tokens))
    jx = JL.embed_tokens(jcfg, jp["embed"], jnp.asarray(tokens, jnp.int32))
    assert x.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(to_np(x), np.asarray(jx, np.float32))   # a gather: exact
    logits = L.logits_head(cfg, p["embed"], x)
    assert rel_err(to_np(logits), JL.logits_head(jcfg, jp["embed"], jx)) < TOL[dtype]


def test_bridge_round_trip_is_exact():
    cfg, jcfg = _cfgs("float32")
    np_tree = jax.tree.map(np.array, jax_api.init_params(jcfg, 0))
    back = params_to_jax(params_from_jax(np_tree, cfg, device="cpu", dtype=torch.float32))
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_a_mismatched_tree():
    cfg, jcfg = _cfgs("float32")
    np_tree = jax.tree.map(np.array, jax_api.init_params(jcfg.replace(d_ff=96), 0))
    with pytest.raises(ValueError, match="layers/0/mlp/w_gate"):
        params_from_jax(np_tree, cfg, device="cpu")


def test_init_is_seeded_and_shaped_by_the_meta_tree():
    cfg = _cfgs("float32")[0]
    a, b = api.init_params(cfg, 0, device="cpu"), api.init_params(cfg, 0, device="cpu")
    c = api.init_params(cfg, 1, device="cpu")
    assert len(a["layers"]) == cfg.num_layers
    wq = a["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.q_dim) and wq.dtype == torch.float32
    assert torch.equal(wq, b["layers"][0]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"][0]["attn"]["wq"])
    assert not torch.equal(wq, a["layers"][1]["attn"]["wq"])
    assert torch.equal(a["final_norm"]["scale"], torch.ones(cfg.d_model))
    # fan-in scaled normal
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


@pytest.mark.parametrize("change,match", [
    (dict(family="ssm", ssm_state=4, ssm_inloop=True), "ssm_inloop.*ROADMAP queue 2"),
])
def test_unported_features_raise_naming_their_slice(change, match):
    cfg = _cfgs("float32")[0].replace(**change)
    with pytest.raises(NotImplementedError, match=match):
        api.init_params(cfg, 0, device="cpu")
