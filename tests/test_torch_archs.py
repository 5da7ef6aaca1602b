"""Every decoder-only arch of both registries, the port against the reference.

The analogue of the reference's `tests/test_archs.py` and of
`tests/test_serve.py::test_prefill_decode_matches_forward`, on smoke configs
(2 layers, narrow widths) with the reference's seed-0 weights bridged into
the port.  The port's prefill runs attn_impl="flash" (on the CPU, the
kernel's plain version) and is held against the reference's naive prefill,
whose kernel path cannot run inside its model (see
`test_torch_serve.py::test_reference_pallas_prefill_raises`).

Tolerances, as max |port - ref| / max |ref|: fp32 2e-5, bf16 0.02.  MoE archs
compare decode with forward at the no-drop capacity (capacity_factor =
num_experts / top_k), as the reference's test does: prefill routes groups of
tokens and decode groups of one, so at the default capacity they drop
different tokens.  In bf16 the MoE forward is compared at the no-drop
capacity too: there the reference disagrees with itself at the default
capacity (its scan-compiled forward and its layers run one by one drop
different tokens; see `test_torch_moe.py`).  And in bf16 a token whose top-k
router probabilities are within NEAR_TIE of the next one at some layer may
take other experts in the two packages (qwen3-moe's smoke config: token
(0, 7) at layer 1, probabilities 0.24330 / 0.24335 here and 0.24351 / 0.24327
in the reference); such a token is exempt from the bf16 limit, and there may
be at most one.  fp32 holds every token, with drops.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import batch_pair, model_pair, prefix, rel_err, step_at, to_np
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models import api as jax_api
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import api

TOL = {"float32": 2e-5, "bfloat16": 0.02}
# router probabilities move by up to 3e-4 between the packages in bf16 at
# smoke size; a k-th / (k+1)-th gap below this is a tie that rounding decides
NEAR_TIE = 1e-3
DTYPES = ["float32", "bfloat16"]
DECODER_ARCHS = sorted(name for name, c in JAX_ARCHS.items() if c.family != "encdec")
NEW_ARCHS = ["h2o-danube-3-4b", "gemma3-4b", "qwen2-vl-2b", "mixtral-8x22b",
             "qwen3-moe-235b-a22b", "llama3-405b"]


def _no_drops(arch):
    c = JAX_ARCHS[arch]
    return {"capacity_factor": c.num_experts / c.top_k} if c.num_experts else {}


def test_registry_holds_every_decoder_only_arch():
    assert sorted(a for a, c in ARCHS.items() if c.family != "encdec") == DECODER_ARCHS
    assert len(DECODER_ARCHS) == 9 and sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_configs_are_field_for_field_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(smoke_config(get_config(arch))) == dataclasses.asdict(
        jax_smoke(JAX_ARCHS[arch]))


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_param_count_matches_reference(arch, smoke):
    cfg, jcfg = get_config(arch), JAX_ARCHS[arch]
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    assert api.param_count(cfg) == jax_api.param_count(jcfg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    cfg, jcfg, jp, p = model_pair(arch, dtype, **(_no_drops(arch) if dtype == "bfloat16"
                                                   else {}))
    batch, jbatch = batch_pair(cfg, 2, 16)
    gaps = _record_router_gaps(2, monkeypatch)
    logits, aux = api.forward(cfg, p, batch, attn_impl="naive")
    jlogits, jaux = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    assert logits.shape == (2, 16, cfg.vocab_size)
    err = np.abs(to_np(logits) - np.asarray(jlogits, np.float32)).max(-1)
    over = err / np.abs(np.asarray(jlogits, np.float32)).max() >= TOL[dtype]
    if cfg.family == "moe" and dtype == "bfloat16":
        tied = np.min(gaps, axis=0) < NEAR_TIE
        assert over.sum() <= 1 and not (over & ~tied).any(), (np.argwhere(over), gaps)
    else:
        assert not over.any(), rel_err(to_np(logits), jlogits)
    if cfg.family == "moe":
        np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL[dtype])
    else:
        assert float(aux) == float(jaux) == 0.0


def _record_router_gaps(B, monkeypatch):
    """A list that gets, per MoE layer the port runs, each token's gap between its
    k-th and (k+1)-th router probabilities ([B, S] for a batch of B)."""
    from repro_torch.models import moe
    gaps, real = [], moe.router_dispatch

    def recording(cfg_, probs, cap):
        top = torch.topk(probs, cfg_.top_k + 1, dim=-1).values
        gaps.append((top[..., -2] - top[..., -1]).reshape(B, -1).numpy())
        return real(cfg_, probs, cap)

    monkeypatch.setattr(moe, "router_dispatch", recording)
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_decode_matches_forward(arch, dtype):
    """The port alone: flash prefill of S-1 positions + one decode step against
    forward's last logits."""
    cfg, _, _, p = model_pair(arch, dtype, **_no_drops(arch))
    B, S = 2, 16
    batch, _ = batch_pair(cfg, B, S)
    full, _ = api.forward(cfg, p, batch, attn_impl="naive")
    _, cache = api.prefill(cfg, p, prefix(batch, S - 1), attn_impl="flash", cache_len=S)
    tok, kw = step_at(batch, S - 1)
    lg, _ = api.decode_step(cfg, p, cache, tok, S - 1, **kw)
    assert rel_err(to_np(lg[:, 0]), to_np(full[:, -1])) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_flash_prefill_and_decode_match_reference(arch, dtype):
    """The port's flash prefill and 4 decode steps against the reference's naive
    prefill and its decode steps, logits and caches."""
    cfg, jcfg, jp, p = model_pair(arch, dtype)
    B, S, P = 2, 16, 12
    batch, jbatch = batch_pair(cfg, B, S)
    lg, cache = api.prefill(cfg, p, prefix(batch, P), attn_impl="flash", cache_len=S)
    jlg, jcache = jax_api.prefill(jcfg, jp, prefix(jbatch, P), attn_impl="naive",
                                  cache_len=S)
    assert rel_err(to_np(lg), jlg) < TOL[dtype]
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    for pos in range(P, S):
        tok, kw = step_at(batch, pos)
        jtok, jkw = step_at(jbatch, pos)
        lg, cache = api.decode_step(cfg, p, cache, tok, pos, **kw)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache, jtok, jnp.int32(pos), **jkw)
        assert rel_err(to_np(lg), jlg) < TOL[dtype], pos
    for name in ("k", "v"):
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_step_factories_serve_the_new_archs(arch, monkeypatch):
    """make_prefill_step / make_decode_step run each new arch's flash prefill
    (one K1 wrapper call per layer) and greedy decode, with bf16 weights."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg, _, _, p = model_pair(arch, "bfloat16")
    batch, _ = batch_pair(cfg, 2, 12)
    calls = []
    real = fa.flash_attention_ref
    monkeypatch.setattr(fa, "flash_attention_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    prefill = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=16)
    lg, cache = prefill(p, batch)
    assert len(calls) == cfg.num_layers
    decode = make_decode_step(cfg)
    tok = lg[:, -1].argmax(-1, keepdim=True)
    for pos in range(12, 16):
        lg, cache = decode(p, cache, tok, pos)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        assert bool(torch.isfinite(lg).all())
    assert tok.shape == (2, 1)
