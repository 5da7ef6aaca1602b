"""gemma3-4b's layers against the reference: the GeGLU MLP (tanh gelu), the
sandwich-norm block and the 5:1 local:global window pattern.

The reference's `jax.nn.gelu` is the tanh approximation by default; torch's
default `F.gelu` is the exact erf form, a different function, so the port
asks for `approximate="tanh"`.

Tolerances, as max |port - ref| / max |ref|: one layer fp32 1e-6 and bf16
8e-3 (as `test_torch_layers.py`); blocks and models fp32 2e-5, bf16 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import batch_pair, model_pair, randn, rel_err, to_np
from repro.models import api as jax_api
from repro.models import layers as JL
from repro.models import transformer as jax_transformer
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import transformer

DTYPES = ["float32", "bfloat16"]
ARCH = "gemma3-4b"


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_geglu_matches_reference(dtype):
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    assert cfg.act == "gelu" and cfg.glu
    x, xn = randn(np.random.default_rng(0), (2, 8, cfg.d_model), dtype)
    out = L.apply_mlp(cfg, p["layers"][0]["mlp"], x)
    ref = JL.apply_mlp(jcfg, _layer(jp, 0)["mlp"], jnp.asarray(xn, dtype))
    assert rel_err(to_np(out), ref) < {"float32": 1e-6, "bfloat16": 8e-3}[dtype]
    # the exact gelu is another function: fp32 tells them apart
    z = torch.linspace(-4, 4, 101)
    assert float((L.act(cfg, z) - F.gelu(z)).abs().max()) > 1e-4
    np.testing.assert_allclose(to_np(L.act(cfg, z)), np.asarray(jax.nn.gelu(z.numpy())),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [16, 0])
def test_sandwich_norm_block_matches_reference(window, dtype):
    """One block, post-norms on the attention and MLP outputs before the residual."""
    cfg, jcfg, jp, p = model_pair(ARCH, dtype)
    assert cfg.sandwich_norm and {"post_norm1", "post_norm2"} <= set(p["layers"][0])
    # non-trivial post-norm scales, the same in both packages
    rng = np.random.default_rng(1)
    jl = dict(_layer(jp, 1))
    port = dict(p["layers"][1])
    for name in ("post_norm1", "post_norm2"):
        scale = (1 + 0.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
        jl[name] = {"scale": jnp.asarray(scale)}
        port[name] = {"scale": torch.from_numpy(scale).to(getattr(torch, dtype))}
    x, xn = randn(rng, (2, 24, cfg.d_model), dtype)
    pos = torch.arange(24)[None].expand(2, 24)
    out, aux, _ = transformer.apply_block(cfg, port, x, pos, window, attn_impl="flash")
    ref, _, _ = jax_transformer.apply_block(jcfg, jl, jnp.asarray(xn, dtype),
                                            jnp.asarray(pos.numpy(), jnp.int32), window,
                                            attn_impl="naive")
    assert aux is None
    assert rel_err(to_np(out), ref) < {"float32": 2e-5, "bfloat16": 0.02}[dtype]


@pytest.mark.parametrize("dtype,pattern", [("float32", (8, 8, 8, 8, 8, 0)),
                                           ("bfloat16", (8, 0))])
def test_window_pattern_prefill_and_decode_match_reference(dtype, pattern):
    """Smoke gemma3 with local windows of 8 and a global layer: flash prefill of
    20 tokens and 4 decode steps against the reference's naive ones.  fp32 runs
    the 5:1 pattern on 6 layers; bf16 the 2 layers the 0.02 limit is set for
    (over 6 layers bf16 rounding alone reads 0.021)."""
    cfg, jcfg, jp, p = model_pair(ARCH, dtype, num_layers=len(pattern),
                                  window_pattern=pattern)
    batch, jbatch = batch_pair(cfg, 2, 24)
    lg, cache = api.prefill(cfg, p, {"tokens": batch["tokens"][:, :20]}, attn_impl="flash",
                            cache_len=24)
    jlg, jcache = jax_api.prefill(jcfg, jp, {"tokens": jbatch["tokens"][:, :20]},
                                  attn_impl="naive", cache_len=24)
    tol = {"float32": 2e-5, "bfloat16": 0.02}[dtype]
    assert rel_err(to_np(lg), jlg) < tol
    for pos in range(20, 24):
        lg, cache = api.decode_step(cfg, p, cache, batch["tokens"][:, pos:pos + 1], pos)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache, jbatch["tokens"][:, pos:pos + 1],
                                          jnp.int32(pos))
        assert rel_err(to_np(lg), jlg) < tol, pos
