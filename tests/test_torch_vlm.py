"""The vlm family (qwen2-vl-2b): M-RoPE and patch embeddings, against the reference.

M-RoPE splits head_dim/2 frequencies into (t, h, w) sections, each turned by
its own row of [3, B, S] position ids; the vlm prefill puts the patch
embeddings in front of the token embeddings.  With no `positions`, the
reference's decode step builds [B, 1] ids of pos and its m-rope reads rows
0, 1 and 2 of them, clamped to the last row when B < 3 (jax clamps an index
past the end): every section turns by pos.  The port builds [3, B, 1] ids of
pos, which gives the same numbers for every B.

Tolerances, as max |port - ref| / max |ref|: fp32 2e-5, bf16 0.02 (the
rope alone: fp32 1e-6, bf16 8e-3, as `test_torch_layers.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import batch_pair, model_pair, prefix, randn, rel_err, step_at, to_np
from repro.models import api as jax_api
from repro.models import layers as JL
from repro_torch.models import api
from repro_torch.models import layers as L

TOL = {"float32": 2e-5, "bfloat16": 0.02}
DTYPES = ["float32", "bfloat16"]
ARCH = "qwen2-vl-2b"


def _grid_positions(rng, B, S):
    """[3, B, S] ids with different t, h and w rows (as a patch grid has)."""
    return np.stack([np.sort(rng.integers(0, S, (B, S)), axis=-1) for _ in range(3)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mrope_matches_reference(dtype):
    cfg, jcfg, _, _ = model_pair(ARCH, dtype)
    rng = np.random.default_rng(0)
    x, xn = randn(rng, (2, 12, cfg.num_heads, cfg.head_dim), dtype)
    pos = _grid_positions(rng, 2, 12)
    out = L.apply_rope(cfg, x, torch.from_numpy(pos))
    ref = JL.apply_rope(jcfg, jnp.asarray(xn, dtype), jnp.asarray(pos, jnp.int32))
    assert rel_err(to_np(out), ref) < {"float32": 1e-6, "bfloat16": 8e-3}[dtype]
    # one row per section: equal rows give the standard rope of that row
    same = np.broadcast_to(pos[0], pos.shape)
    std = L.apply_rope(cfg.replace(rope="standard"), x, torch.from_numpy(pos[0]))
    torch.testing.assert_close(L.apply_rope(cfg, x, torch.from_numpy(same.copy())), std,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_with_patches_matches_reference(dtype):
    """Flash prefill of patches + tokens with grid positions, then decode steps
    with [3, B, 1] ids, against the reference's naive prefill and decode."""
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    B, S, P = 2, 24, 20
    batch, jbatch = batch_pair(cfg, B, S)
    assert batch["patch_embeds"].shape == (B, api.n_image_patches(cfg, S), cfg.d_model)
    pos = _grid_positions(np.random.default_rng(1), B, S)
    batch["positions"] = torch.from_numpy(pos).to(torch.int32)
    jbatch["positions"] = jnp.asarray(pos, jnp.int32)
    lg, cache = api.prefill(cfg, p, prefix(batch, P), attn_impl="flash", cache_len=S)
    jlg, jcache = jax_api.prefill(jcfg, jp, prefix(jbatch, P), attn_impl="naive", cache_len=S)
    assert rel_err(to_np(lg), jlg) < TOL[dtype]
    for name in ("k", "v"):
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name
    for i in range(P, S):
        (tok, kw), (jtok, jkw) = step_at(batch, i), step_at(jbatch, i)
        lg, cache = api.decode_step(cfg, p, cache, tok, i, **kw)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache, jtok, jnp.int32(i), **jkw)
        assert rel_err(to_np(lg), jlg) < TOL[dtype], i


@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_decode_without_positions_matches_reference(B):
    """positions=None: the port's decode against the reference's, whose m-rope
    reads rows of [B, 1] ids (clamped for B < 3), and against the port's own
    decode with [3, B, 1] ids of pos; fp32, 6 steps from an empty cache."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    cfg, jcfg, jp, p = model_pair(ARCH, "float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 6))
    cache = transformer.init_cache(cfg, B, 8, windowed=False, device="cpu")
    own = transformer.init_cache(cfg, B, 8, windowed=False, device="cpu")
    jcache = jax_transformer.init_cache(jcfg, B, 8, windowed=False)
    for t in range(6):
        tok = torch.from_numpy(toks[:, t:t + 1])
        lg, cache = api.decode_step(cfg, p, cache, tok, t)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache, jnp.asarray(tok.numpy(), jnp.int32),
                                          jnp.int32(t))
        assert rel_err(to_np(lg), jlg) < TOL["float32"], t
        ids = torch.full((3, B, 1), t, dtype=torch.int32)
        lg_own, own = api.decode_step(cfg, p, own, tok, t, positions=ids)
        assert torch.equal(lg, lg_own), t


@pytest.mark.parametrize("B", [1, 2])
def test_decode_attention_without_positions_matches_reference(B):
    """decode_attention itself with positions=None on m-rope (B < 3, where [B, 1] ids
    have fewer rows than the 3 sections): the port builds [3, B, 1] ids of pos, the
    reference reads clamped rows of [B, 1]; fp32, output and both caches."""
    import jax
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    cfg, jcfg, jp, p = model_pair(ARCH, "float32")
    rng = np.random.default_rng(3)
    Sc, pos = 8, 5
    x, xn = randn(rng, (B, 1, cfg.d_model), "float32")
    (ck, ckn), (cv, cvn) = (randn(rng, (B, Sc, cfg.num_kv_heads, cfg.head_dim), "float32")
                            for _ in range(2))
    out, k, v = attention.decode_attention(cfg, p["layers"][0]["attn"], x, ck.clone(),
                                           cv.clone(), pos)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jout, jk, jv = jax_attention.decode_attention(jcfg, jattn, jnp.asarray(xn), jnp.asarray(ckn),
                                                  jnp.asarray(cvn), jnp.int32(pos))
    for a, b in ((out, jout), (k, jk), (v, jv)):
        assert rel_err(to_np(a), b) < TOL["float32"]
