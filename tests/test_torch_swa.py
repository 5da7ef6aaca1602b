"""Sliding-window attention: the windowed ring cache and the cache layouts.

The port's ring-cache decode (`decode_attention(windowed_cache=True)`, slot
pos % Sc, keys attended without order once warm) against the reference's,
token by token from an empty cache; the port's own checks of the reference's
`test_windowed_ring_cache_matches_full` and `test_multi_step_decode_consistent`;
the per-layer-list cache of a model whose layers have different windows; and
`api.cache_specs` against the reference's for every ported arch and shape.

Tolerances, as max |port - ref| / max |ref|: fp32 2e-5, bf16 0.02 (the
reference's serving tests hold the ring against the full cache at 0.08 in
bf16; the port holds its own at the same 0.08 in bf16 and 2e-5 in fp32).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import batch_pair, model_pair, rel_err, to_np
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import api as jax_api
from repro.models import transformer as jax_transformer
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.models import api, transformer

TOL = {"float32": 2e-5, "bfloat16": 0.02}
DTYPES = ["float32", "bfloat16"]


def _decode_both(arch, dtype, B, S, cache_len, windowed, **change):
    """Both packages decode the same S tokens one by one from an empty cache of
    `cache_len`; yields (t, port logits, reference logits, port cache, ref cache).
    The reference's step is jit-compiled in fp32 (for time) and run op by op in
    bf16, where XLA's fused step rounds differently (gemma3's list cache: 0.022
    at step 22 compiled, within 0.02 op by op)."""
    cfg, jcfg, jp, p = model_pair(arch, dtype, **change)
    batch, jbatch = batch_pair(cfg, B, S)
    cache = transformer.init_cache(cfg, B, cache_len, windowed=windowed, device="cpu")
    jcache = jax_transformer.init_cache(jcfg, B, cache_len, windowed=windowed)
    jstep = lambda params, c, tok, pos: jax_api.decode_step(jcfg, params, c, tok, pos)  # noqa
    if dtype == "float32":
        jstep = jax.jit(jstep)
    for t in range(S):
        lg, cache = api.decode_step(cfg, p, cache, batch["tokens"][:, t:t + 1], t)
        jlg, jcache = jstep(jp, jcache, jbatch["tokens"][:, t:t + 1], jnp.int32(t))
        yield t, lg, jlg, cache, jcache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2])
def test_ring_cache_decode_matches_reference(B, dtype):
    """h2o-danube-3-4b's smoke config (window 16), a ring of exactly 16 slots,
    32 tokens: every step's logits and, at the end, the ring's contents."""
    w = 16
    for t, lg, jlg, cache, jcache in _decode_both("h2o-danube-3-4b", dtype, B, 32, w, True):
        assert cache["k"].shape[2] == w
        assert rel_err(to_np(lg), jlg) < TOL[dtype], t
    for name in ("k", "v"):
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_ring_cache_matches_full(dtype):
    """The port's own check of the reference's test of the same name: ring decode
    == full-cache windowed decode once the ring is warm."""
    cfg, _, _, p = model_pair("h2o-danube-3-4b", dtype)
    B, S, w = 1, 32, cfg.window
    toks = api.demo_batch(cfg, B, S, device="cpu")["tokens"]
    full = transformer.init_cache(cfg, B, S, windowed=False, device="cpu")
    ring = transformer.init_cache(cfg, B, w, windowed=True, device="cpu")
    assert ring["k"].shape[2] == w and full["k"].shape[2] == S
    limit = {"float32": 2e-5, "bfloat16": 0.08}[dtype]
    for t in range(S):
        lf, full = api.decode_step(cfg, p, full, toks[:, t:t + 1], t)
        lr, ring = api.decode_step(cfg, p, ring, toks[:, t:t + 1], t)
        if t >= w:
            assert rel_err(to_np(lr), to_np(lf)) < limit, t


@pytest.mark.parametrize("dtype", DTYPES)
def test_multi_step_decode_consistent(dtype):
    """Decoding 4 tokens after a flash prefill matches teacher-forced forward."""
    cfg, _, _, p = model_pair("h2o-danube-3-4b", dtype)
    B, S = 1, 32                                   # past the window of 16
    toks = api.demo_batch(cfg, B, S, device="cpu")["tokens"]
    full, _ = api.forward(cfg, p, {"tokens": toks}, attn_impl="naive")
    P = S - 4
    _, cache = api.prefill(cfg, p, {"tokens": toks[:, :P]}, attn_impl="flash", cache_len=S)
    for pos in range(P, S):
        lg, cache = api.decode_step(cfg, p, cache, toks[:, pos:pos + 1], pos)
        assert rel_err(to_np(lg[:, 0]), to_np(full[:, pos])) < TOL[dtype], pos


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,pattern", [("gemma3-4b", (16, 0)), ("hymba-1.5b", (0, 16))])
def test_per_layer_list_cache_matches_reference(arch, pattern, dtype):
    """Layers with different windows and windowed=True: a list of per-layer
    caches, a ring of 16 on the windowed layer and the full 24 on the other."""
    change = dict(window_pattern=pattern)
    for t, lg, jlg, cache, jcache in _decode_both(arch, dtype, 2, 24, 24, True, **change):
        assert rel_err(to_np(lg), jlg) < TOL[dtype], t
    assert isinstance(cache, list) and isinstance(jcache, list)
    assert [e["k"].shape[1] for e in cache] == [16 if w else 24 for w in pattern]
    for e, je in zip(cache, jcache):
        assert e.keys() == je.keys()
        for name in e:
            assert rel_err(to_np(e[name]), je[name]) < TOL[dtype], name


def test_short_window_cache_is_not_a_ring():
    """A windowed cache shorter than the window (seq_len < window) is no ring in
    either package: its slot is the position itself."""
    cfg, _, _, p = model_pair("h2o-danube-3-4b", "float32")
    cache = transformer.init_cache(cfg, 1, 8, windowed=True, device="cpu")
    assert cache["k"].shape[2] == 8 < cfg.window
    for t in range(8):
        _, cache = api.decode_step(cfg, p, cache, torch.tensor([[t + 1]]), t)
    assert bool((cache["k"][:, 0, 7] != 0).any())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, shape):
    specs = api.cache_specs(ARCHS[arch], SHAPES[shape])
    ref = jax_api.cache_specs(JAX_ARCHS[arch], JAX_SHAPES[shape])

    def plain(entry):
        return {name: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
                for name, s in entry.items()}

    if isinstance(ref, dict):
        assert isinstance(specs, dict) and plain(specs) == plain(ref)
    else:
        assert isinstance(specs, list) and [plain(e) for e in specs] == [plain(e) for e in ref]


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b", "h2o-danube-3-4b",
                                  "falcon-mamba-7b"])
def test_init_cache_is_laid_out_by_cache_specs(arch, windowed):
    from repro_torch.configs import smoke_config
    cfg = smoke_config(ARCHS[arch])
    if arch in ("gemma3-4b", "hymba-1.5b"):
        cfg = cfg.replace(window_pattern=(16, 0))
    specs = transformer.cache_specs(cfg, 2, 40, windowed=windowed)
    cache = transformer.init_cache(cfg, 2, 40, windowed=windowed, device="cpu")
    pairs = zip(specs, cache) if isinstance(specs, list) else [(specs, cache)]
    for spec, entry in pairs:
        assert {n: (tuple(t.shape), t.dtype) for n, t in entry.items()} == {
            n: (s.shape, s.dtype) for n, s in spec.items()}
        assert all(not t.any() for t in entry.values())
    assert isinstance(cache, list) == (windowed and arch in ("gemma3-4b", "hymba-1.5b"))
