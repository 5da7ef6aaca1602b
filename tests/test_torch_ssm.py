"""The port's SSM slice vs the reference: the scan kernel's plain version, the
Mamba block, and smoke falcon-mamba-7b / hymba-1.5b end to end, same weights.

The scan kernel's plain version (`repro_torch.kernels.ref.mamba_scan_ref`,
which the wrapper runs for CPU tensors) is held against the reference's Pallas
kernel in interpret mode and its oracle, at the reference's tolerance (max abs
error 1e-4).  The reference model never calls its kernel (`models/ssm.py` runs
an XLA associative scan), so the port's SSM layers, which launch the scan once
per layer, are held against the reference's `apply_ssm`/`decode_ssm` and the
model's forward, prefill and decode.

Model tolerances, as max |port - ref| / max |ref|: fp32 2e-5 (the rtol of the
reference's `test_fused_loss_equals_reference`), bf16 0.02 (the reference's
`test_serve.py`).  Layer tolerances: fp32 1e-5, bf16 8e-3 as in
`test_torch_layers.py`, with the fp32 one 10x wider: the reference's chunked
associative scan sums in another order than the sequential loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MAMBA_CASES, batch_pair, max_abs_err, model_pair, rel_err,
                           scan_inputs, to_np)
from repro.configs import ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.kernels.mamba_scan import mamba_scan as ms_kernel
from repro.kernels.ref import mamba_scan_ref as jax_scan_ref
from repro.models import api as jax_api
from repro.models import ssm as jax_ssm
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import api, ssm, transformer
from repro_torch.models.meta import leaves, tree_map

ARCH_NAMES = ["falcon-mamba-7b", "hymba-1.5b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 0.02}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _setup(arch, dtype):
    cfg = smoke_config(get_config(arch)).replace(compute_dtype=dtype)
    jcfg = jax_smoke(ARCHS[arch]).replace(compute_dtype=dtype)
    jp = jax_api.init_params(jcfg, 0)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _jax_final_state(a, bx):
    """The reference's sequential scan for the final state
    (`repro.models.transformer._ssm_with_state`)."""
    def step(h, t):
        return t[0] * h + t[1], None
    h0 = jnp.zeros((a.shape[0], a.shape[2], a.shape[3]), jnp.float32)
    h, _ = jax.lax.scan(step, h0, (jnp.swapaxes(a, 0, 1), jnp.swapaxes(bx, 0, 1)))
    return h


# --------------------------------------------------------------------------
# the scan kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,Di,N,chunk,di_block", MAMBA_CASES)
def test_scan_plain_version_matches_pallas_kernel(B, S, Di, N, chunk, di_block):
    a, bx, c = scan_inputs(S + Di + N, B, S, Di, N)
    y, h = ms.mamba_scan(*map(torch.from_numpy, (a, bx, c)), return_state=True)
    ja, jbx, jc = map(jnp.asarray, (a, bx, c))
    pallas = ms_kernel(ja, jbx, jc, chunk=chunk, di_block=di_block, interpret=True)
    assert y.shape == (B, S, Di) and y.dtype == torch.float32
    assert max_abs_err(to_np(y), pallas) < 1e-4
    assert max_abs_err(to_np(y), jax_scan_ref(ja, jbx, jc)) < 1e-4
    assert h.shape == (B, Di, N)
    assert max_abs_err(to_np(h), _jax_final_state(ja, jbx)) < 1e-4


@pytest.mark.parametrize("seed", range(6))
def test_scan_plain_version_seeded_sweep(seed):
    """The reference's `test_mamba_scan_property`, with seeded draws of its
    strategies in place of hypothesis."""
    rng = np.random.default_rng(1000 + seed)
    S, Di, N = (int(rng.choice(v)) for v in ([64, 128, 192, 256], [32, 64, 128], [4, 8, 16]))
    a, bx, c = scan_inputs(int(rng.integers(0, 2 ** 16)), 1, S, Di, N)
    y = ms.mamba_scan(*map(torch.from_numpy, (a, bx, c)))
    pallas = ms_kernel(*map(jnp.asarray, (a, bx, c)), chunk=64, di_block=32, interpret=True)
    assert max_abs_err(to_np(y), pallas) < 1e-4


def test_scan_wrapper_takes_cpu_tensors_to_the_plain_version_uncounted():
    a, bx, c = map(torch.from_numpy, scan_inputs(3, 2, 33, 16, 5))
    before = ms.launches
    y, h = ops.mamba_scan(a, bx, c, return_state=True)
    ref_y, ref_h = mamba_scan_ref(a, bx, c, return_state=True)
    assert torch.equal(y, ref_y) and torch.equal(h, ref_h)
    assert ms.launches == before
    y16 = ops.mamba_scan(a.bfloat16(), bx.bfloat16(), c.bfloat16())   # ops casts to fp32
    assert y16.dtype == torch.float32
    empty = ms.mamba_scan(a[:, :0], bx[:, :0], c[:, :0], return_state=True)
    assert empty[0].shape == (2, 0, 16) and not empty[1].any()


def test_scan_wrapper_rejects_what_the_kernel_does_not_take():
    a, bx, c = map(torch.from_numpy, scan_inputs(4, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ms.mamba_scan(a.to("meta"), bx.to("meta"), c.to("meta"))
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan(a.double(), bx.double(), c.double())
    with pytest.raises(ValueError, match="bad shapes"):
        ms.mamba_scan(a, bx, c[:, :, :2])
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros(1, 4, 8, 33)
        ms.mamba_scan(big, big, torch.zeros(1, 4, 33))
    assert build.library_path(ms.SOURCE).parent.name == "repro_torch"
    assert build.library_path(ms.SOURCE).name.startswith("libmamba_scan_")


@pytest.mark.parametrize("S,chunk", [(96, 32), (100, 32), (256, 256), (40, 64)])
def test_chunked_scan_matches_the_reference_and_the_sequential_gradients(S, chunk):
    """`ssm.scan_chunked`, the training path's differentiable scan, in chunks
    of `chunk` (halved until it divides S: 100 runs chunks of 4): y and the
    final state against the reference's oracle and sequential scan (max abs
    1e-4, the scan tolerance), and the gradients of a weighted sum of both
    against those through the sequential plain version (relative 2e-5)."""
    a, bx, c = scan_inputs(S + chunk, 2, S, 16, 4)
    w = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 16)).astype(np.float32))
    got = []
    for fn in (lambda *t: ssm.scan_chunked(*t, return_state=True, chunk=chunk),
               lambda *t: mamba_scan_ref(*t, return_state=True)):
        ins = [torch.from_numpy(t).requires_grad_() for t in (a, bx, c)]
        y, h = fn(*ins)
        ((y * w).sum() + h.sum()).backward()
        got.append((y, h, [t.grad for t in ins]))
    (y, h, grads), (_, _, want) = got
    ja, jbx, jc = map(jnp.asarray, (a, bx, c))
    assert max_abs_err(to_np(y), jax_scan_ref(ja, jbx, jc)) < 1e-4
    assert max_abs_err(to_np(h), _jax_final_state(ja, jbx)) < 1e-4
    for g, ref in zip(grads, want):
        assert rel_err(to_np(g), to_np(ref)) < 2e-5


def test_chunked_scan_keeps_about_its_inputs_for_backward():
    """Autograd's saved tensors of `scan_chunked` at S = 1024 (4 chunks of 256)
    come to under 2.5 x one [B, S, Di, N] fp32 tensor (a_bar and bx are 2 of
    it; the carried states and c the rest), where one doubling over S kept
    ~25 and unrecomputed chunks ~18."""
    a, bx, c = (torch.from_numpy(t).requires_grad_() for t in scan_inputs(9, 1, 1024, 32, 8))
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ssm.scan_chunked(a, bx, c)
    assert sum(storages.values()) < 2.5 * a.numel() * a.element_size()
    y.sum().backward()
    assert a.grad is not None and torch.isfinite(a.grad).all()


# --------------------------------------------------------------------------
# the Mamba block
# --------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"]["ssm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_ssm_and_decode_ssm_match_reference(dtype):
    cfg, jcfg, jp, p = _setup("falcon-mamba-7b", dtype)
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    jx = jnp.asarray(x.float().numpy(), jdt)
    lp, jlp = p["layers"][0]["ssm"], _layer0(jp)
    out, state = ssm.apply_ssm(cfg, lp, x, return_state=True)
    assert torch.equal(out, ssm.apply_ssm(cfg, lp, x))
    assert rel_err(to_np(out), jax_ssm.apply_ssm(jcfg, jlp, jx)) < LAYER_TOL[dtype]
    # the final state of the same launch vs the reference's rerun of the scan
    xz = jx @ jlp["in_proj"].astype(jdt)
    x_in = xz[..., :cfg.d_inner]
    xc = jax.nn.silu(jax_ssm._conv1d_causal(jcfg, jlp, x_in))
    ja, jbx, _ = jax_ssm._ssm_inputs(jcfg, jlp, xc, cfg.d_model)
    assert state["conv"].dtype == state["ssm"].dtype == torch.float32
    assert rel_err(to_np(state["ssm"]), _jax_final_state(ja, jbx)) < LAYER_TOL[dtype]
    assert rel_err(to_np(state["conv"]), x_in[:, -3:].astype(jnp.float32)) < LAYER_TOL[dtype]

    xt = x[:, :1]
    out1, st1 = ssm.decode_ssm(cfg, lp, xt, state)
    jout1, jst1 = jax_ssm.decode_ssm(jcfg, jlp, jx[:, :1],
                                     {"conv": jnp.asarray(to_np(state["conv"])),
                                      "ssm": jnp.asarray(to_np(state["ssm"]))})
    assert rel_err(to_np(out1), jout1) < LAYER_TOL[dtype]
    for name in ("conv", "ssm"):
        assert rel_err(to_np(st1[name]), jst1[name]) < LAYER_TOL[dtype], name


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_scan_plain_version_matches_ssm_inputs_and_the_pallas_kernel(arch, dtype):
    """K2's fused entry point (its plain version, the CPU path) on the port's
    `_ssm_params` of layer 0 against the reference's `_ssm_inputs` on the same
    params and conv output, scanned by its Pallas kernel in interpret mode: y
    and the final state within 1e-4 (x in the compute dtype, bf16 widened)."""
    cfg, jcfg, jp, p = _setup(arch, dtype)
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(11)
    xc = rng.standard_normal((2, 64, cfg.d_inner)).astype(np.float32)
    xt = torch.from_numpy(xc).to(getattr(torch, dtype))
    jxc = jnp.asarray(xt.float().numpy(), jdt)
    lp, jlp = p["layers"][0]["ssm"], _layer0(jp)
    delta, a, b, c = ssm._ssm_params(cfg, lp, xt)
    y, h = ops.mamba_scan_fused(delta, xt, a, b, c, return_state=True)
    ja, jbx, jc = jax_ssm._ssm_inputs(jcfg, jlp, jxc, cfg.d_model)
    pallas = ms_kernel(ja, jbx, jc, chunk=32, di_block=cfg.d_inner, interpret=True)
    assert y.shape == (2, 64, cfg.d_inner) and y.dtype == torch.float32
    assert max_abs_err(to_np(y), pallas) < 1e-4
    assert max_abs_err(to_np(h), _jax_final_state(ja, jbx)) < 1e-4


def test_fused_scan_wrapper_takes_cpu_tensors_to_the_plain_version_uncounted():
    """The fused wrapper's CPU path is `mamba_scan_fused_ref`, which builds a_bar
    and bx as `_ssm_inputs` does and scans them with `mamba_scan_ref`; it counts
    no launch and checks what the kernel would not take."""
    rng = np.random.default_rng(5)
    delta, x = (torch.from_numpy(rng.random((2, 33, 16)).astype(np.float32)) for _ in range(2))
    a = -torch.from_numpy(rng.random((16, 5)).astype(np.float32))
    b, c = (torch.from_numpy(rng.standard_normal((2, 33, 5)).astype(np.float32))
            for _ in range(2))
    before = ms.launches, dict(ms.kernel_launches)
    y, h = ops.mamba_scan_fused(delta, x.bfloat16(), a, b, c, return_state=True)
    a_bar = (delta[..., None] * a).exp()
    bx = (delta * x.bfloat16().float())[..., None] * b[..., None, :]
    ref_y, ref_h = mamba_scan_ref(a_bar, bx, c, return_state=True)
    assert torch.equal(y, ref_y) and torch.equal(h, ref_h)
    assert (ms.launches, ms.kernel_launches) == before
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan_fused(delta.double(), x, a, b, c)
    with pytest.raises(ValueError, match="bad shapes"):
        ms.mamba_scan_fused(delta, x, a, b[:, :, :2], c)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan_fused(delta, x, torch.zeros(16, 33), torch.zeros(2, 33, 33),
                            torch.zeros(2, 33, 33))


@pytest.mark.parametrize("B,S,Di,N,chunks", [
    (4, 1024, 8192, 16, 1),     # falcon-mamba-7b's prefill: 256 blocks, 1.94 an SM
    (4, 2048, 3200, 16, 6),     # hymba-1.5b's: 100 blocks, 600 in 6 chunks
    (2, 2048, 800, 16, 16),     # hymba-1.5b's on rank 0 of (2, 4): at most S // 128
    (1, 96, 64, 4, 1),          # fewer than 2 x 128 steps: one chunk
    (1, 1000, 96, 16, 7),
])
def test_scan_chunks_come_from_the_shape_and_the_sm_count(B, S, Di, N, chunks):
    assert ms.scan_chunks(B, S, Di, N, 132) == chunks


def test_short_prompt_conv_state_is_zero_padded():
    """Fewer tokens than d_conv-1: the state holds zeros before the first token,
    which is what decode's conv would have seen."""
    cfg, _, _, p = _setup("falcon-mamba-7b", "float32")
    x = torch.randn(1, 2, cfg.d_model, generator=torch.Generator().manual_seed(0))
    lp = p["layers"][0]["ssm"]
    _, state = ssm.apply_ssm(cfg, lp, x, return_state=True)
    x_in = (x @ lp["in_proj"])[..., :cfg.d_inner]
    assert state["conv"].shape == (1, cfg.d_conv - 1, cfg.d_inner)
    assert not state["conv"][:, 0].any() and torch.equal(state["conv"][:, 1:], x_in)
    # stepping the same two tokens through decode from the empty state agrees
    st = ssm.init_ssm_state(cfg, 1, device="cpu")
    for t in range(2):
        _, st = ssm.decode_ssm(cfg, lp, x[:, t:t + 1], st)
    for name in ("conv", "ssm"):
        assert max_abs_err(to_np(st[name]), to_np(state[name])) < 1e-5, name


def test_ssm_init_matches_reference():
    cfg, jcfg, _, _ = _setup("falcon-mamba-7b", "bfloat16")
    jp = jax_api.init_params(jcfg, 0)
    p = api.init_params(cfg, 0, device="cpu")
    lp, jlp = p["layers"][1]["ssm"], jax.tree.map(lambda a: a[1], jp["layers"]["ssm"])
    for name in ("dt_bias", "a_log", "d_skip", "conv_b"):
        ref = np.asarray(jlp[name])
        assert lp[name].dtype == (torch.float32 if name != "conv_b" else torch.bfloat16)
        assert np.array_equal(to_np(lp[name]), ref.astype(to_np(lp[name]).dtype)), name
    assert lp["in_proj"].dtype == torch.bfloat16
    assert api.param_count(cfg) == jax_api.param_count(jcfg)


# --------------------------------------------------------------------------
# ssm_inloop: each chunk discretised inside its checkpoint
# --------------------------------------------------------------------------

def _inloop_inputs(seed, B, S, Di, N):
    """delta > 0, x, A < 0, B and C for the scan, fp32, as `_ssm_params` makes them."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, Di)) - 2))
    a = -np.exp(rng.standard_normal((Di, N)) * 0.5)
    return [torch.from_numpy(t.astype(np.float32)) for t in
            (delta, rng.standard_normal((B, S, Di)), a, rng.standard_normal((B, S, N)),
             rng.standard_normal((B, S, N)))]


@pytest.mark.parametrize("S,chunk", [(96, 32), (100, 32), (40, 64)])
def test_inloop_scan_is_the_chunked_scan_of_the_discretised_inputs(S, chunk):
    """`ssm.scan_inloop` against `scan_chunked` on `_discretise`'s a_bar and bx:
    y and the final state equal bit for bit (the discretisation is elementwise),
    and the gradients of delta, x, A, B and C within 2e-5 (A's sums its
    chunks' parts in another order)."""
    ins = _inloop_inputs(S, 2, S, 16, 4)
    w = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 16)).astype(np.float32))
    got = []
    for inloop in (True, False):
        live = [t.clone().requires_grad_() for t in ins]
        if inloop:
            y, h = ssm.scan_inloop(*live, return_state=True, chunk=chunk)
        else:
            delta, x, a, b, c = live
            y, h = ssm.scan_chunked(*ssm._discretise(delta, x, a, b), c, return_state=True,
                                    chunk=chunk)
        ((y * w).sum() + h.sum()).backward()
        got.append((y, h, [t.grad for t in live]))
    (y, h, grads), (y0, h0, want) = got
    assert torch.equal(y, y0) and torch.equal(h, h0)
    for g, ref in zip(grads, want):
        assert rel_err(to_np(g), to_np(ref)) < 2e-5


def _saved_bytes(fn):
    """The bytes of the storages autograd saves for backward while `fn` runs."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(storages.values())


def test_inloop_ssm_keeps_less_than_one_discretised_tensor_for_backward():
    """The plain path of `apply_ssm` at B=1, S=1024 (4 chunks of 256), Di=64,
    N=16: with `ssm_inloop`, autograd's saved tensors come to less than one
    [B, S, Di, N] fp32 tensor; without it, a_bar alone is saved whole (its
    exp's output).  The gradients agree (the scan's, chunk by chunk)."""
    cfg = smoke_config(get_config("falcon-mamba-7b")).replace(
        compute_dtype="float32", d_model=32, ssm_state=16)
    p = api.init_params(cfg, 0, device="cpu", dtype=torch.float32)["layers"][0]["ssm"]
    x = torch.randn(1, 1024, cfg.d_model, generator=torch.Generator().manual_seed(0))
    one = 1024 * cfg.d_inner * cfg.ssm_state * 4
    grads = {}
    for flag in (True, False):
        live = {k: v.detach().requires_grad_() for k, v in p.items()}
        out, saved = _saved_bytes(lambda: ssm.apply_ssm(cfg.replace(ssm_inloop=flag), live, x,
                                                        scan_impl="plain"))
        assert (saved < one) if flag else (saved >= one), (flag, saved, one)
        out.square().mean().backward()
        grads[flag] = {k: v.grad for k, v in live.items()}
    for k in p:
        assert rel_err(to_np(grads[True][k]), to_np(grads[False][k])) < 2e-5, k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inloop_forward_loss_and_gradients_match_reference(arch):
    """With `ssm_inloop` in both packages, fp32, 2 x 320 (5 chunks of 64):
    logits, the training loss and every parameter's gradient through
    `scan_impl="plain"` against the reference's forward, loss_fn and
    jax.grad, within 2e-5."""
    cfg, jcfg, jp, _ = model_pair(arch, "float32", ssm_inloop=True)
    p = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu", dtype=torch.float32)
    batch, jbatch = batch_pair(cfg, 2, 320)
    with torch.no_grad():
        lg, _ = api.forward(cfg, p, batch, attn_impl="naive")
    jlg, _ = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    assert rel_err(to_np(lg), jlg) < TOL["float32"]
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    loss = api.loss_fn(cfg, live, batch, scan_impl="plain", remat="dots")
    grads = torch.autograd.grad(loss, list(leaves(live)))
    jloss, jgrads = jax.value_and_grad(lambda q: jax_api.loss_fn(jcfg, q, jbatch))(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL["float32"])
    it = iter(grads)
    port = jax.tree.leaves(params_to_jax(tree_map(lambda _: next(it), p)))
    ref = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(port) == len(ref)
    for a, (path, b) in zip(port, ref):
        assert rel_err(a, b) < TOL["float32"], jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inloop_prefill_launches_the_fused_scan_per_layer_and_equals_flag_off(arch,
                                                                             monkeypatch):
    """Prefill with `ssm_inloop` runs K2's fused wrapper once per SSM layer (the
    kernel is the in-loop form) and gives the flag-off prefill's logits and
    cache exactly."""
    cfg, _, _, p = _setup(arch, "float32")
    calls = []
    real = ms.mamba_scan_fused
    monkeypatch.setattr(ms, "mamba_scan_fused", lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = api.demo_batch(cfg, 2, 12, device="cpu")
    out = {}
    for flag in (True, False):
        step = make_prefill_step(cfg.replace(ssm_inloop=flag), StepSettings(attn_impl="flash"),
                                 cache_len=16)
        out[flag] = step(p, batch)
        assert len(calls) == cfg.num_layers, flag
        calls.clear()
    (lg, cache), (lg0, cache0) = out[True], out[False]
    assert torch.equal(lg, lg0)
    for a, b in zip(leaves(cache), leaves(cache0)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# smoke models end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_matches_reference(arch, dtype):
    cfg, jcfg, jp, p = _setup(arch, dtype)
    toks = _tokens(cfg, 2, 24)
    lg, aux = api.forward(cfg, p, {"tokens": torch.from_numpy(toks)}, attn_impl="flash")
    jlg, _ = jax_api.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             attn_impl="naive")
    assert float(aux) == 0.0 and lg.shape == (2, 24, cfg.vocab_size)
    assert rel_err(to_np(lg), jlg) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_and_decode_match_reference(arch, dtype):
    """20-token prompts (past hymba's smoke window of 16), then 4 decode steps."""
    cfg, jcfg, jp, p = _setup(arch, dtype)
    B, P, cache_len = 2, 20, 32
    toks = _tokens(cfg, B, P + 4)
    lg, cache = api.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :P])},
                            attn_impl="flash", cache_len=cache_len)
    jlg, jcache = jax_api.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)},
                                  attn_impl="naive", cache_len=cache_len)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert cache[name].shape == tuple(jcache[name].shape), name
    assert rel_err(to_np(lg), jlg) < TOL[dtype]
    for pos in range(P, P + 4):
        lg, cache = api.decode_step(cfg, p, cache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        jlg, jcache = jax_api.decode_step(jcfg, jp, jcache,
                                          jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                          jnp.int32(pos))
        assert rel_err(to_np(lg), jlg) < TOL[dtype], pos
    for name in cache:
        assert rel_err(to_np(cache[name]), jcache[name]) < TOL[dtype], name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_decode_matches_forward(arch):
    """The port's own check of the reference's test_prefill_decode_matches_forward."""
    cfg = smoke_config(get_config(arch))
    p = api.init_params(cfg, 0, device="cpu")
    B, S = 2, 16
    batch = api.demo_batch(cfg, B, S, device="cpu")
    full, _ = api.forward(cfg, p, batch, attn_impl="naive")
    _, cache = api.prefill(cfg, p, {"tokens": batch["tokens"][:, :-1]},
                           attn_impl="flash", cache_len=S)
    lg, _ = api.decode_step(cfg, p, cache, batch["tokens"][:, -1:], S - 1)
    assert rel_err(to_np(lg[:, 0]), to_np(full[:, -1])) < 0.02


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_runs_each_kernel_wrapper_once_per_layer(arch, monkeypatch):
    """One fused scan per SSM layer (the final state comes from the same launch) and,
    for hybrid, one flash attention per layer; decode runs neither."""
    cfg, _, _, p = _setup(arch, "float32")
    calls = {"scan": [], "flash": []}
    for mod, name, key in ((ms, "mamba_scan_fused", "scan"), (fa, "flash_attention", "flash")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k:
                            calls[_k].append(k.get("return_state")) or _r(*a, **k))
    batch = api.demo_batch(cfg, 2, 12, device="cpu")
    lg, cache = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=16)(p, batch)
    assert calls["scan"] == [True] * cfg.num_layers
    assert len(calls["flash"]) == (cfg.num_layers if cfg.family == "hybrid" else 0)
    api.forward(cfg, p, batch, attn_impl="flash")
    assert calls["scan"][cfg.num_layers:] == [False] * cfg.num_layers
    for key in calls:
        calls[key].clear()
    lg2, cache2 = make_decode_step(cfg)(p, cache, batch["tokens"][:, -1:], 12)
    assert cache2 is cache and calls == {"scan": [], "flash": []}


def test_pad_kv_pads_only_keys_and_values():
    """The SSM state has no sequence axis: its dim 2 (conv's d_conv-1 axis) is
    not padded, as in the reference's `_pad_kv`."""
    L, B, S, Di, N = 2, 3, 5, 8, 4
    caches = {"k": torch.ones(L, B, S, 2, 4), "v": torch.ones(L, B, S, 2, 4),
              "conv": torch.ones(L, B, 3, Di), "ssm": torch.ones(L, B, Di, N)}
    padded = transformer._pad_kv(caches, 9)
    assert padded["k"].shape == padded["v"].shape == (L, B, 9, 2, 4)
    assert not padded["k"][:, :, S:].any()
    assert padded["conv"] is caches["conv"] and padded["ssm"] is caches["ssm"]
    cfg, _, _, p = _setup("falcon-mamba-7b", "float32")
    _, cache = api.prefill(cfg, p, api.demo_batch(cfg, 2, 6, device="cpu"), cache_len=64)
    assert cache["conv"].shape == (cfg.num_layers, 2, cfg.d_conv - 1, cfg.d_inner)
    assert cache["ssm"].shape == (cfg.num_layers, 2, cfg.d_inner, cfg.ssm_state)
    assert sorted(cache) == sorted(transformer.init_cache(cfg, 2, 64, windowed=False,
                                                          device="cpu"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_bridge_round_trip(arch):
    cfg, _, jp, p = _setup(arch, "float32")
    tree = jax.tree.map(np.array, jp)
    back = params_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)


_CAPTURE = r"""
import json, sys
sys.path.insert(0, {tests!r})
import torch
from _torch_dist_worker import capture_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings
from repro_torch.models import api
from repro_torch.optim import adamw
cfg = smoke_config(get_config("hymba-1.5b")).replace(compute_dtype="float32")
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
params = api.init_params(cfg, 0, device="cpu", dtype=torch.float32)
batch = {{k: v.numpy() for k, v in api.demo_batch(cfg, 8, 64, device="cpu").items()}}
out = {{}}
for flag in (False, True):
    tr = capture_step(mesh, spec, dict(cfg=cfg.replace(ssm_inloop=flag), opt_cfg=adamw.AdamWConfig(),
                                       settings=StepSettings(accum=2, remat="dots"),
                                       params=params, batch=batch))
    out[str(flag)] = sorted([e.op_name, e.kind, str(e.replica_groups), e.operand_bytes, e.dtype,
                             e.multiplicity, e.semantic] for e in tr.events)
print("SITES" + json.dumps(out))
"""


def test_inloop_train_step_captures_the_flag_off_site_table():
    """The smoke hymba-1.5b train step (fp32, 8 x 64, accum 2, remat "dots") as
    rank 0 of (2, 4) under the fake process group, captured with and without
    `ssm_inloop`: the same collective sites, since each rank scans its own
    channels and rows (the in-loop scan's gradients leave as the plain
    scan's do: A's partial over `data`, B's and C's over `model`)."""
    import json
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(tests), "src"),
           "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", _CAPTURE.format(tests=tests)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    sites = json.loads(next(l for l in res.stdout.splitlines()
                            if l.startswith("SITES"))[len("SITES"):])
    assert sites["True"] and sites["True"] == sites["False"]
