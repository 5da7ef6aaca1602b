"""Training numerics of the port against the reference: losses, gradients,
AdamW and its schedule, the synthetic data stream, and the kernels' autograd
guard.

The analogues of `tests/test_system.py::test_fused_loss_equals_reference`
and `::test_fused_loss_gradients_match`, `tests/test_train.py::
test_adamw_matches_reference`, `::test_schedule_bounds` and
`::test_data_determinism_and_seek`, on smoke configs with the reference's
seed-0 weights bridged into the port at fp32, and numpy-seeded inputs.

Tolerances: the fused loss against full-logits cross-entropy rtol 2e-5 (the
reference test's); losses and gradients between the packages at fp32, max
|port - ref| / max |ref| per leaf 2e-5 (the parity tests' fp32 limit; the
readings were 5e-7 to 1.3e-6); AdamW in fp32 rtol 1e-6 (one elementwise
formula on equal inputs), with bf16 moments one bf16 step (2^-7 relative);
the schedule rtol 1e-6.  Data batches are bitwise equal.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _hypothesis_compat import given, settings, strategies as st
from _torch_parity import (assert_cpu_training_takes_the_plain_scan, batch_pair, model_pair,
                           to_np)
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as jax_api
from repro.models import losses as JLoss
from repro.optim import adamw as jadamw
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.models import api, losses, transformer
from repro_torch.models.meta import leaves, tree_map
from repro_torch.optim import adamw

# the reference's tests/test_archs.py::FAMILY_REPS
FAMILY_REPS = ["chatglm3-6b", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b",
               "whisper-tiny", "qwen2-vl-2b"]
F32_TOL = 2e-5


def fp32_pair(arch, **change):
    """(port cfg, reference cfg, reference params, port fp32 master params)."""
    cfg, jcfg, jp, _ = model_pair(arch, "float32", **change)
    p = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu", dtype=torch.float32)
    return cfg, jcfg, jp, p


def grads_of(cfg, p, batch, **kw):
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    loss = api.loss_fn(cfg, live, batch, **kw)
    grads = torch.autograd.grad(loss, list(leaves(live)))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), p)


def assert_trees_close(port_tree, ref_tree, tol):
    """Per leaf, max |port - ref| / max |ref| < tol; both in the reference's layout."""
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = jax.tree.leaves(port_tree)
    assert len(port_leaves) == len(ref_flat)
    for a, (path, b) in zip(port_leaves, ref_flat):
        b = np.asarray(b, np.float32)
        err = np.abs(np.asarray(a, np.float32) - b).max() / (np.abs(b).max() + 1e-12)
        assert err < tol, (jax.tree_util.keystr(path), err)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def test_fused_loss_equals_full_logits_cross_entropy():
    """The analogue of tests/test_system.py::test_fused_loss_equals_reference:
    chunked head + cross-entropy (chunk 8) against cross-entropy of the full
    logits, rtol 2e-5; and both against the reference's on the same hidden states."""
    cfg, jcfg, jp, p = fp32_pair("chatglm3-6b")
    B, S = 2, 32
    batch, jbatch = batch_pair(cfg, B, S)
    hidden, _ = transformer.forward_hidden(cfg, p, batch, attn_impl="naive")
    targets = torch.roll(batch["tokens"], -1, dims=1)
    mask = torch.ones((B, S))
    mask[:, -1] = 0.0
    fused = losses.fused_lm_head_loss(cfg, p["embed"], hidden, targets, mask, chunk=8)
    from repro_torch.models.layers import logits_head
    ref = losses.cross_entropy(logits_head(cfg, p["embed"], hidden), targets, mask)
    np.testing.assert_allclose(float(fused), float(ref), rtol=2e-5)
    jhidden = jnp.asarray(to_np(hidden))
    jfused = JLoss.fused_lm_head_loss(jcfg, jp["embed"], jhidden, jnp.asarray(targets.numpy()),
                                      jnp.asarray(mask.numpy()), chunk=8)
    np.testing.assert_allclose(float(fused), float(jfused), rtol=F32_TOL)


@pytest.mark.parametrize("S,V", [(32, 256), (1024, 16384)])
def test_cross_entropy_matches_reference(S, V):
    """One block, and (S * V > 2^23) the chunked path, with a mask."""
    rng = np.random.default_rng(S)
    logits = rng.standard_normal((2, S, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (2, S))
    mask = (rng.random((2, S)) < 0.9).astype(np.float32)
    out = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                               torch.from_numpy(mask))
    ref = JLoss.cross_entropy(jnp.asarray(logits), jnp.asarray(targets, jnp.int32),
                              jnp.asarray(mask))
    np.testing.assert_allclose(float(out), float(ref), rtol=F32_TOL)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mixtral-8x22b", "whisper-tiny"])
def test_lm_loss_and_fused_loss_match_reference(arch):
    """Full-logits lm_loss and the fused next-token loss, with the vlm's text
    slice and the MoE's aux term, in both packages."""
    cfg, jcfg, jp, p = fp32_pair(arch)
    batch, jbatch = batch_pair(cfg, 2, 32)
    logits, aux = api.forward(cfg, p, batch, attn_impl="naive")
    jlogits, jaux = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    lm = losses.lm_loss(cfg, logits, batch, aux)
    np.testing.assert_allclose(float(lm), float(JLoss.lm_loss(jcfg, jlogits, jbatch, jaux)),
                               rtol=F32_TOL)
    fused = api.loss_fn(cfg, p, batch)
    np.testing.assert_allclose(float(fused), float(lm), rtol=F32_TOL)


@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_loss_fn_value_and_gradients_match_reference(arch):
    """api.loss_fn and its gradient (train path: plain scan, remat "dots")
    against jax.value_and_grad of the reference's loss_fn, fp32 compute."""
    cfg, jcfg, jp, p = fp32_pair(arch)
    batch, jbatch = batch_pair(cfg, 2, 32)
    loss, grads = grads_of(cfg, p, batch, remat="dots")
    jloss, jgrads = jax.value_and_grad(lambda q: jax_api.loss_fn(jcfg, q, jbatch))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_TOL)
    assert_trees_close(params_to_jax(grads), jgrads, F32_TOL)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_give_the_same_gradients_and_recompute_as_named():
    """none, dots and full give equal gradients.  In backward, "full" recomputes
    each layer's forward, matmuls included; "dots" recomputes the rest of it but
    none of its unbatched matmuls (aten.mm), whose outputs it saved."""
    cfg, _, _, p = fp32_pair("hymba-1.5b")
    batch, _ = batch_pair(cfg, 2, 32)
    grads, backward_ops = {}, {}
    for remat in ("none", "dots", "full"):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = api.loss_fn(cfg, live, batch, remat=remat)
        with _CountOps() as count:
            grads[remat] = torch.autograd.grad(loss, list(leaves(live)))
        backward_ops[remat] = count.ops
    for remat in ("dots", "full"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    mm = {r: ops[torch.ops.aten.mm.default] for r, ops in backward_ops.items()}
    total = {r: sum(ops.values()) for r, ops in backward_ops.items()}
    assert mm["dots"] == mm["none"] < mm["full"], mm
    assert total["none"] < total["dots"] < total["full"], total


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8), "b": {"n": (8,), "s": (3, 2)}}
    mk = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return mk(1.0), mk(0.5)


@pytest.mark.parametrize("clip_norm,state_dtype", [(1.0, "float32"), (0.0, "float32"),
                                                    (1.0, "bfloat16")])
def test_adamw_update_matches_reference(clip_norm, state_dtype):
    """Three steps of adamw.update from the same params and gradients (clip on,
    off, and bf16 moments); params, moments, count, grad_norm and lr."""
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm,
                state_dtype=state_dtype)
    cfg, jcfg = adamw.AdamWConfig(**ocfg), jadamw.AdamWConfig(**ocfg)
    params_n, grads_n = _opt_inputs()
    # the port updates in place, so it gets its own copy (jax on the CPU may
    # alias a numpy buffer)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params_n)
    jparams = jax.tree.map(jnp.asarray, params_n)
    state, jstate = adamw.init(cfg, params), jadamw.init(jcfg, jparams)
    for step in range(3):
        g = jax.tree.map(lambda a: a * (1 + step), grads_n)
        params, state, metrics = adamw.update(cfg, jax.tree.map(torch.from_numpy, g), state,
                                              params)
        jparams, jstate, jmetrics = jadamw.update(jcfg, jax.tree.map(jnp.asarray, g), jstate,
                                                  jparams)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    rtol = 2.0 ** -7 if state_dtype == "bfloat16" else 1e-6
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(state[name]), jax.tree.leaves(jstate[name])):
            assert a.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=rtol, atol=1e-12)


def test_adamw_matches_hand_computed_step():
    """The analogue of tests/test_train.py::test_adamw_matches_reference."""
    cfg = adamw.AdamWConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.0,
                            clip_norm=0.0, warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    before = p["w"].clone()
    new_p, _, _ = adamw.update(cfg, {"w": torch.tensor([0.5, 0.5])}, adamw.init(cfg, p), p)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    step = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), before.numpy() - 0.1 * step, rtol=1e-5)


@given(step=st.integers(0, 12_000))
@settings(max_examples=30, deadline=None)
def test_schedule_matches_reference_and_stays_in_bounds(step):
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    lr = float(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    ref = float(jadamw.schedule(jadamw.AdamWConfig(lr=3e-4, warmup_steps=100,
                                                   total_steps=10_000), jnp.asarray(step)))
    np.testing.assert_allclose(lr, ref, rtol=1e-6, atol=1e-12)
    assert 0.0 <= lr <= cfg.lr * (1 + 1e-6)
    if step >= cfg.total_steps:
        assert lr <= cfg.lr * cfg.min_lr_ratio * (1 + 1e-4) + 1e-9


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-tiny", "qwen2-vl-2b"])
def test_synthetic_tokens_are_bitwise_the_reference_stream(arch):
    """batch_at and iter_from give the reference's arrays, bit for bit, on the
    same SeedSequence([seed, step]) draws; the encdec and vlm extras too."""
    cfg, jcfg = smoke_config(get_config(arch)), jax_smoke(JAX_ARCHS[arch])
    data = SyntheticTokens(cfg, DataConfig(3, 40, seed=7))
    ref = JSyntheticTokens(jcfg, JDataConfig(3, 40, seed=7))
    for step, (a, b) in enumerate(zip(data.iter_from(10), ref.iter_from(10))):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key])
        if step == 2:
            break
    assert not np.array_equal(data.batch_at(10)["tokens"], data.batch_at(11)["tokens"])
    tokens = data.batch_at(10)["tokens"]
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab_size


# --------------------------------------------------------------------------
# the kernels inside autograd
# --------------------------------------------------------------------------

def test_kernel_wrappers_raise_under_autograd(monkeypatch):
    """K1 and K2's prefill entry points have no backward: with grad mode on and
    an input that requires grad, each wrapper raises instead of returning an
    output without a gradient (on the CPU, where it would run the plain
    version, too), K2's naming the training entry point; under no_grad, or
    with no input requiring grad, it runs.  A loss with flash attention
    raises; the training loss on the CPU takes the plain scan, calling no K2
    entry point: the same loss and gradients as with the scan taken
    explicitly through `ref.scan_chunked`, bit for bit."""
    q = torch.randn(1, 2, 8, 16)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    a, bx, c = torch.rand(1, 8, 4, 2), torch.randn(1, 8, 4, 2), torch.randn(1, 8, 2)
    qr, ar = q.clone().requires_grad_(), a.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(qr, k, v)
    with pytest.raises(RuntimeError, match="no backward.*mamba_scan_train"):
        ms.mamba_scan(ar, bx, c)
    delta, x = torch.rand(1, 8, 4), torch.randn(1, 8, 4)
    with pytest.raises(RuntimeError, match="no backward.*mamba_scan_train"):
        ms.mamba_scan_fused(delta.clone().requires_grad_(), x, -torch.rand(4, 2),
                            torch.randn(1, 8, 2), c, torch.randn(4), torch.randn(4),
                            torch.randn(1, 8, 4))
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(qr, k, v), fa.flash_attention(q, k, v))
        assert torch.equal(ms.mamba_scan(ar, bx, c), ms.mamba_scan(a, bx, c))
    cfg, _, _, p = fp32_pair("hymba-1.5b")
    batch, _ = batch_pair(cfg, 2, 16)
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(cfg, live, batch, attn_impl="flash")
    assert_cpu_training_takes_the_plain_scan(cfg, p, batch, monkeypatch)


def test_vocab_parallel_pick_takes_plain_tensors():
    """The mesh's vocab-parallel (logsumexp, target logit) on plain tensors, as a
    straight run with the mesh's formulation swapped in calls it, equals the
    straight formulation's."""
    from repro_torch.models import losses
    rng = np.random.default_rng(3)
    lf = torch.from_numpy(rng.standard_normal((2, 8, 50)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 50, (2, 8)))
    for got, want in zip(losses._lse_and_target_vocab_parallel(lf, targets),
                         losses._lse_and_target(lf, targets)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
