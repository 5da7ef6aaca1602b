"""The port's serving path vs the reference on smoke configs, same weights:
chatglm3-6b's flash prefill and decode, and every decoder-only arch's
`BatchedServer` tokens.

The port's prefill runs with attn_impl="flash" (on the CPU, the kernel's
plain version) and is held against the reference's prefill with
attn_impl="naive": the reference's own kernel path cannot run inside its
prefill (see `test_reference_pallas_prefill_raises`).

Tolerances, as max |port - ref| / max |ref|: fp32 2e-5 (the rtol of the
reference's `test_fused_loss_equals_reference`); bf16 0.02 (the reference's
`test_serve.py`).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err, to_np
from repro.configs import ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 2e-5, "bfloat16": 0.02}
DTYPES = ["float32", "bfloat16"]


def _setup(dtype, arch="chatglm3-6b"):
    cfg = smoke_config(get_config(arch)).replace(compute_dtype=dtype)
    jcfg = jax_smoke(ARCHS[arch]).replace(compute_dtype=dtype)
    jp = jax_api.init_params(jcfg, 0)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_and_decode_match_reference(dtype):
    cfg, jcfg, jp, p = _setup(dtype)
    B, S, P = 2, 16, 12
    toks = _tokens(cfg, B, S)
    lg, cache = api.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :P])},
                            attn_impl="flash", cache_len=S)
    jlg, jcache = jax_api.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)},
                                  attn_impl="naive", cache_len=S)
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert cache["k"].shape == tuple(jcache["k"].shape) == (cfg.num_layers, B, S, 2, 16)
    assert rel_err(to_np(lg), jlg) < TOL[dtype]
    for name in ("k", "v"):
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name
    for pos in range(P, P + 4):
        lg, cache = api.decode_step(cfg, p, cache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache,
                                          jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                          jnp.int32(pos))
        assert rel_err(to_np(lg), jlg) < TOL[dtype], pos
    for name in ("k", "v"):
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_decode_matches_forward(dtype):
    """The port's own check of the reference's test_prefill_decode_matches_forward."""
    cfg = smoke_config(get_config("chatglm3-6b")).replace(compute_dtype=dtype)
    p = api.init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    batch = api.demo_batch(cfg, B, S, device="cpu")
    full, aux = api.forward(cfg, p, batch, attn_impl="naive")
    assert float(aux) == 0.0
    _, cache = api.prefill(cfg, p, {"tokens": batch["tokens"][:, :-1]},
                           attn_impl="flash", cache_len=S)
    lg, _ = api.decode_step(cfg, p, cache, batch["tokens"][:, -1:], S - 1)
    assert rel_err(to_np(lg[:, 0]), to_np(full[:, -1])) < 0.02


def test_step_factories_run_the_flash_wrapper_once_per_layer(monkeypatch):
    cfg, _, _, p = _setup("float32")
    calls = []
    real = ops.fa.flash_attention
    monkeypatch.setattr(ops.fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = api.demo_batch(cfg, 2, 12, device="cpu")
    prefill = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=16)
    lg, cache = prefill(p, batch)
    assert len(calls) == cfg.num_layers
    ref_lg, ref_cache = api.prefill(cfg, p, batch, attn_impl="flash", cache_len=16)
    assert torch.equal(lg, ref_lg) and torch.equal(cache["k"], ref_cache["k"])
    decode = make_decode_step(cfg)
    tok = batch["tokens"][:, -1:]
    calls.clear()
    lg2, cache2 = decode(p, cache, tok, 12)
    assert cache2 is cache                     # updated in place
    assert not calls                           # decode attention is naive, as in the reference
    assert torch.equal(lg2, api.decode_step(cfg, p, ref_cache, tok, 12)[0])


def _record_logits(srv, to_host):
    """Wrap srv._decode; returns the list of [max_batch, V] logits per call."""
    calls = []
    inner = srv._decode

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        calls.append(to_host(out[0][:, 0]))
        return out

    srv._decode = wrapped
    return calls


def _drive(srv, reqs, decisions=None, calls=None):
    """The reference test's scheduling loop; `decisions` collects the
    (call index, slot) pairs whose argmax became a token."""
    queue = list(reqs)
    for _ in range(64):
        for slot in range(srv.max_batch):
            if srv.slots[slot] is None and queue:
                srv.prefill_into_slot(slot, queue.pop(0))
                if decisions is not None:
                    decisions.append((len(calls) - 1, slot))
        active = [i for i, r in enumerate(srv.slots) if r and not r.done]
        srv.decode_round()
        if decisions is not None:
            decisions.extend((len(calls) - 1, i) for i in active)
        if all(r.done for r in reqs):
            break


def test_batched_server_greedy_tokens_match_reference():
    _server_greedy_tokens_match_reference("chatglm3-6b")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_batched_server_greedy_tokens_match_reference_ssm_families(arch):
    """The same check for the families with Mamba layers, whose slots' SSM
    state also advances on the other slots' prompt steps."""
    _server_greedy_tokens_match_reference(arch)


@pytest.mark.parametrize("arch,max_batch", [
    ("h2o-danube-3-4b", 2), ("gemma3-4b", 2), ("llama3-405b", 2), ("mixtral-8x22b", 2),
    ("qwen3-moe-235b-a22b", 2), ("qwen2-vl-2b", 2), ("qwen2-vl-2b", 4)])
def test_batched_server_greedy_tokens_match_reference_decoder_families(arch, max_batch):
    """The same check for the other decoder-only archs.  The MoE decode step
    routes each token alone (groups of one), so nothing is dropped; qwen2-vl
    decodes with no positions, which both packages turn into m-rope ids of the
    position on every axis, with fewer slots than rows of ids (2) and more (4).

    The MoE archs' logit limit is 2e-3: the server's cache is bf16 (in both
    packages) under fp32 compute, and a value whose fp32 results differ by
    rounding between the packages rounded to neighbouring bf16 values in their
    runs (mixtral: one element of layer 1's v, 1.78125 against 1.7890625),
    which moved the later logits by up to 8.8e-4.  Equal tokens still follow
    from the margin check."""
    moe = get_config(arch).family == "moe"
    _server_greedy_tokens_match_reference(arch, max_batch, logit_tol=2e-3 if moe else 1e-4)


def _server_greedy_tokens_match_reference(arch, max_batch=2, logit_tol=1e-4):
    """3 requests through 2 slots, fp32: the same greedy tokens as the reference.

    The logits must agree within LOGIT_TOL (1e-4 unless the caller says
    otherwise) at every call, and at every
    choice the reference's top-1/top-2 margin must exceed 2 * LOGIT_TOL, which
    makes equal argmaxes a consequence of the logit bound.  At a near-tie
    (margin <= 2 * LOGIT_TOL) the greedy tokens are not comparable: the test
    fails and names the step; it is not re-seeded around one.  The run is
    fp32 because bf16 rounding differences between XLA and PyTorch are of the
    size of a typical top-2 margin here (bf16 logits are held by
    `test_flash_prefill_and_decode_match_reference`).
    """
    LOGIT_TOL = logit_tol
    cfg, jcfg, jp, p = _setup("float32", arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 4) for _ in range(3)]

    jsrv = jax_serve.BatchedServer(jcfg, jp, max_batch=max_batch, cache_len=32)
    jcalls = _record_logits(jsrv, lambda a: np.asarray(a, np.float32))
    jreqs = [jax_serve.Request(i, pr.astype(np.int32), 4) for i, pr in enumerate(prompts)]
    decisions = []
    _drive(jsrv, jreqs, decisions, jcalls)

    srv = serve.BatchedServer(cfg, p, max_batch=max_batch, cache_len=32)
    calls = _record_logits(srv, to_np)
    reqs = [serve.Request(i, pr, 4) for i, pr in enumerate(prompts)]
    _drive(srv, reqs)

    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert len(calls) == len(jcalls)
    for n, (a, b) in enumerate(zip(calls, jcalls)):
        assert np.abs(a - b).max() < LOGIT_TOL, f"call {n}: logits differ"
    for n, slot in decisions:
        top2 = np.sort(jcalls[n][slot])[-2:]
        assert top2[1] - top2[0] > 2 * LOGIT_TOL, (
            f"near-tie at call {n}, slot {slot}: margin {top2[1] - top2[0]:.2e}")
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_batched_server_end_to_end():
    cfg = smoke_config(get_config("chatglm3-6b"))
    srv = serve.BatchedServer(cfg, api.init_params(cfg, 0, device="cpu"),
                              max_batch=2, cache_len=32)
    rng = np.random.default_rng(0)
    reqs = [serve.Request(i, rng.integers(0, cfg.vocab_size, 4), 4) for i in range(3)]
    srv.run(reqs)
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert srv.slots == [None, None]


def test_reference_pallas_prefill_raises():
    """Why the slice is held against the naive prefill: the reference's
    windows ride through lax.scan as traced values, and its kernel wrapper
    (kernels/ops.py:38) calls int() on one."""
    _, jcfg, jp, _ = _setup("float32")
    batch = {"tokens": jnp.zeros((1, 8), jnp.int32)}
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax_api.prefill(jcfg, jp, batch, attn_impl="pallas")


def test_entry_points_never_drift_to_the_cpu():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        cfg = smoke_config(get_config("chatglm3-6b"))
        for call in (lambda: api.init_params(cfg, 0), lambda: api.demo_batch(cfg, 1, 4),
                     lambda: resolve_device("cuda")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_serve_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "chatglm3-6b",
         "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "3 requests, 12 tokens" in res.stdout
