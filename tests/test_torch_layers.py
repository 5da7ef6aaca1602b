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
from repro_torch.models.meta import leaves

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


def _fresh_rope(cfg, x, positions):
    L._last_tables = None
    return L.apply_rope(cfg, x, positions)


def _count_angles(monkeypatch):
    calls = []
    real = L._rope_angles
    monkeypatch.setattr(L, "_rope_angles", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_tables_are_made_once_per_positions_tensor(dtype, monkeypatch):
    """apply_rope keeps the last call's cos/sin: q and k of every layer that
    take one positions tensor make them once, with the bits of tables made
    afresh; new positions, positions changed in place, another head dim or
    dtype, and inference tensors make them again."""
    cfg, _ = _cfgs(dtype)
    rng = np.random.default_rng(3)
    q, _ = randn(rng, (2, 12, cfg.num_heads, cfg.head_dim), dtype)
    k, _ = randn(rng, (2, 12, cfg.num_kv_heads, cfg.head_dim), dtype)
    pos = torch.arange(3, 15)[None].expand(2, 12).contiguous()
    want_q, want_k = _fresh_rope(cfg, q, pos), _fresh_rope(cfg, k, pos)
    calls = _count_angles(monkeypatch)
    L._last_tables = None
    for _ in range(3):                                  # three layers
        assert torch.equal(L.apply_rope(cfg, q, pos), want_q)
        assert torch.equal(L.apply_rope(cfg, k, pos), want_k)
    assert len(calls) == 1
    L.apply_rope(cfg, k, pos.clone())                   # equal values, another tensor
    assert len(calls) == 2
    pos.add_(1)                                         # changed in place
    got = L.apply_rope(cfg, q, pos)
    assert len(calls) == 3 and torch.equal(got, _fresh_rope(cfg, q, pos))
    L.apply_rope(cfg, q.float() if dtype == "bfloat16" else q.bfloat16(), pos)
    assert len(calls) == 5                              # (the fresh one above, then this)
    with torch.inference_mode():
        ipos = torch.arange(12)[None].expand(2, 12)
        for _ in range(2):
            L.apply_rope(cfg, q, ipos)
    assert len(calls) == 7


def test_prefill_makes_rope_tables_once():
    """A prefill of every layer's q and k makes RoPE's cos/sin once, from the
    step's one positions tensor."""
    from repro_torch.models import transformer
    cfg = smoke_config(get_config("chatglm3-6b"))
    p = api.init_params(cfg, 0, device="cpu")
    batch = api.demo_batch(cfg, 2, 16, device="cpu")
    L._last_tables = None
    want = transformer.prefill(cfg, p, batch)
    mp = pytest.MonkeyPatch()
    calls = _count_angles(mp)
    try:
        L._last_tables = None
        got = transformer.prefill(cfg, p, batch)
    finally:
        mp.undo()
    assert cfg.num_layers > 1 and len(calls) == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1]["k"], want[1]["k"])


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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_inloop_is_accepted_by_init_params_and_forward(arch):
    """`ssm_inloop` changes only the training scan: the params and the
    forward (the scan kernel's path) are the flag-off ones."""
    cfg = smoke_config(get_config(arch)).replace(compute_dtype="float32")
    p = api.init_params(cfg.replace(ssm_inloop=True), 0, device="cpu")
    for a, b in zip(leaves(p), leaves(api.init_params(cfg, 0, device="cpu"))):
        assert torch.equal(a, b)
    batch = api.demo_batch(cfg, 2, 8, device="cpu")
    lg, _ = api.forward(cfg.replace(ssm_inloop=True), p, batch)
    assert torch.equal(lg, api.forward(cfg, p, batch)[0])
