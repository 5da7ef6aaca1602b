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

from _torch_parity import (MAMBA_CASES, assert_cpu_training_takes_the_plain_scan, batch_pair,
                           max_abs_err, model_pair, rel_err, scan_inputs, to_np)
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
from repro_torch.kernels import ops, ref
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
    """`ref.scan_chunked`, the training path's differentiable scan, in chunks
    of `chunk` (halved until it divides S: 100 runs chunks of 4): y and the
    final state against the reference's oracle and sequential scan (max abs
    1e-4, the scan tolerance), and the gradients of a weighted sum of both
    against those through the sequential plain version (relative 2e-5)."""
    a, bx, c = scan_inputs(S + chunk, 2, S, 16, 4)
    w = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 16)).astype(np.float32))
    got = []
    for fn in (lambda *t: ref.scan_chunked(*t, return_state=True, chunk=chunk),
               lambda *t: mamba_scan_ref(*t, return_state=True)):
        ins = [torch.from_numpy(t).requires_grad_() for t in (a, bx, c)]
        y, h = fn(*ins)
        ((y * w).sum() + h.sum()).backward()
        got.append((y, h, [t.grad for t in ins]))
    (y, h, grads), (_, _, want) = got
    ja, jbx, jc = map(jnp.asarray, (a, bx, c))
    assert max_abs_err(to_np(y), jax_scan_ref(ja, jbx, jc)) < 1e-4
    assert max_abs_err(to_np(h), _jax_final_state(ja, jbx)) < 1e-4
    for g, g0 in zip(grads, want):
        assert rel_err(to_np(g), to_np(g0)) < 2e-5


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
        y = ref.scan_chunked(a, bx, c)
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
    """K2's fused entry point's plain version (its CPU path) on the port's
    `_ssm_params` of layer 0 against the reference's `_ssm_inputs` on the same
    params and conv output, scanned by its Pallas kernel in interpret mode: y
    and the final state within 1e-4 (x in the compute dtype, bf16 widened).
    The entry point itself, from the raw dt projection, gives that scan gated
    by the mixer's ops bit for bit, and its final state."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import mamba_scan_fused_ref
    cfg, jcfg, jp, p = _setup(arch, dtype)
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(11)
    xc = rng.standard_normal((2, 64, cfg.d_inner)).astype(np.float32)
    xt = torch.from_numpy(xc).to(getattr(torch, dtype))
    jxc = jnp.asarray(xt.float().numpy(), jdt)
    lp, jlp = p["layers"][0]["ssm"], _layer0(jp)
    delta, a, b, c = ssm._ssm_params(cfg, lp, xt)
    y, h = mamba_scan_fused_ref(delta, xt, a, b, c, return_state=True)
    ja, jbx, jc = jax_ssm._ssm_inputs(jcfg, jlp, jxc, cfg.d_model)
    pallas = ms_kernel(ja, jbx, jc, chunk=32, di_block=cfg.d_inner, interpret=True)
    assert y.shape == (2, 64, cfg.d_inner) and y.dtype == torch.float32
    assert max_abs_err(to_np(y), pallas) < 1e-4
    assert max_abs_err(to_np(h), _jax_final_state(ja, jbx)) < 1e-4
    dt, _, _, _ = ssm._ssm_proj(cfg, lp, xt)
    z = torch.from_numpy(rng.standard_normal(xc.shape).astype(np.float32)).to(xt.dtype)
    gy, gh = ops.mamba_scan_fused(dt, xt, a, b, c, lp["dt_bias"], lp["d_skip"], z,
                                  return_state=True)
    want = (y + xt.float() * lp["d_skip"].float()).to(xt.dtype) * F.silu(z)
    assert gy.dtype == xt.dtype and torch.equal(gy, want) and torch.equal(gh, h)


def test_fused_scan_wrapper_takes_cpu_tensors_to_the_plain_version_uncounted():
    """The fused wrapper's CPU path is `mamba_scan_fused_ref`, which makes delta
    = softplus(dt + delta_bias), builds a_bar and bx as `_ssm_inputs` does,
    scans them with `mamba_scan_ref` and gates the result as the mixer does;
    it counts no launch and checks what the kernel would not take."""
    import torch.nn.functional as F
    rng = np.random.default_rng(5)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    dt, x, z = t(2, 33, 16), t(2, 33, 16), t(2, 33, 16)
    a = -torch.from_numpy(rng.random((16, 5)).astype(np.float32))
    b, c, bias, d_skip = t(2, 33, 5), t(2, 33, 5), t(16), t(16)
    before = ms.launches, dict(ms.kernel_launches)
    y, h = ops.mamba_scan_fused(dt, x.bfloat16(), a, b, c, bias, d_skip, z, return_state=True)
    xb, zb = x.bfloat16(), z.bfloat16()
    delta = F.softplus(dt.bfloat16().float() + bias)
    a_bar = (delta[..., None] * a).exp()
    bx = (delta * xb.float())[..., None] * b[..., None, :]
    ref_y, ref_h = mamba_scan_ref(a_bar, bx, c, return_state=True)
    want = (ref_y + xb.float() * d_skip).bfloat16() * F.silu(zb)
    assert torch.equal(y, want) and torch.equal(h, ref_h)
    assert (ms.launches, ms.kernel_launches) == before
    with pytest.raises(TypeError, match="float32"):
        ms.mamba_scan_fused(dt.double(), x, a, b, c, bias, d_skip, z)
    with pytest.raises(ValueError, match="bad shapes"):
        ms.mamba_scan_fused(dt, x, a, b[:, :, :2], c, bias, d_skip, z)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan_fused(dt, x, torch.zeros(16, 33), torch.zeros(2, 33, 33),
                            torch.zeros(2, 33, 33), bias, d_skip, z)


@pytest.mark.parametrize("B,S,Di,N,chunks", [
    (4, 1024, 8192, 16, 1),     # falcon-mamba-7b's prefill: 256 blocks, 1.94 an SM
    (4, 2048, 3200, 16, 6),     # hymba-1.5b's: 100 blocks, 600 in 6 chunks
    (2, 2048, 800, 16, 16),     # hymba-1.5b's on rank 0 of (2, 4): at most S // 128
    (1, 96, 64, 4, 1),          # fewer than 2 x 128 steps: one chunk
    (1, 1000, 96, 16, 7),
])
def test_scan_chunks_come_from_the_shape_and_the_sm_count(B, S, Di, N, chunks):
    assert ms.scan_chunks(B, S, Di, N, 132) == chunks


# --------------------------------------------------------------------------
# the fused call's gate: the mixer's dt prologue and gated output in K2
# --------------------------------------------------------------------------

def _gated_inputs(seed, B, S, Di, N, dtype):
    """The fused call's arguments as the mixer passes them: the raw dt projection
    and x in `dtype`, A, B, C, dt_bias and d_skip fp32, and z the gate half of an
    in_proj output, a strided view."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    dt, x = (t(B, S, Di) - 1.0).to(dtype), t(B, S, Di).to(dtype)
    a = -torch.exp(0.5 * t(Di, N))
    z = t(B, S, 2 * Di).to(dtype)[..., Di:]
    return dt, x, a, t(B, S, N), t(B, S, N), 0.5 * t(Di), t(Di), z


def _record_fused_calls(monkeypatch):
    """The list each fused call appends to: whether it took all eight arguments."""
    calls = []
    real = ms.mamba_scan_fused
    monkeypatch.setattr(ms, "mamba_scan_fused",
                        lambda *a, **k: calls.append(len(a) == 8) or real(*a, **k))
    return calls


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_plain_version_is_the_mixer_s_op_sequence_bit_for_bit(dtype, return_state):
    """`mamba_scan_fused_ref` with the gate equals the mixer's ops bit for bit:
    delta = softplus(dt.float() + dt_bias), the plain scan, then y + x·D in
    fp32, rounded to x's dtype and times silu(z); its h_S is the ungated
    scan's.  The wrapper's CPU path is that plain version and counts nothing."""
    from repro_torch.kernels.ref import mamba_scan_fused_ref
    dt, x, a, b, c, bias, d_skip, z = ins = _gated_inputs(3, 2, 40, 24, 16, getattr(torch, dtype))
    before = ms.launches, dict(ms.kernel_launches)
    got = ops.mamba_scan_fused(*ins, return_state=return_state)
    plain = mamba_scan_fused_ref(*ins, return_state=return_state)
    assert (ms.launches, ms.kernel_launches) == before
    delta = torch.nn.functional.softplus(dt.float() + bias.float())
    y, h = mamba_scan_ref((delta[..., None] * a).exp(),
                          (delta * x.float())[..., None] * b[..., None, :], c, return_state=True)
    want = (y + x.float() * d_skip).to(x.dtype) * torch.nn.functional.silu(z)
    for out in (got, plain):
        out_y = out[0] if return_state else out
        assert out_y.dtype == x.dtype and torch.equal(out_y, want)
        if return_state:
            assert torch.equal(out[1], h)
            assert torch.equal(out[1], mamba_scan_fused_ref(delta, x, a, b, c,
                                                            return_state=True)[1])


def test_gated_call_takes_its_arguments_together():
    """The plain version takes delta_bias, d_skip and z together or not at all;
    the wrapper takes dt and z in x's dtype and the gate's shapes, on every
    device."""
    from repro_torch.kernels.ref import mamba_scan_fused_ref
    dt, x, a, b, c, bias, d_skip, z = _gated_inputs(4, 1, 8, 16, 4, torch.bfloat16)
    for part in ((bias, None, None), (bias, d_skip, None), (None, None, z)):
        with pytest.raises(ValueError, match="together"):
            mamba_scan_fused_ref(dt, x, a, b, c, *part)
    with pytest.raises(TypeError, match="x's dtype"):
        ms.mamba_scan_fused(dt, x, a, b, c, bias, d_skip, z.float())
    with pytest.raises(TypeError, match="bfloat16 delta"):
        ms.mamba_scan_fused(dt.float(), x, a, b, c, bias, d_skip, z)
    with pytest.raises(ValueError, match="bad shapes"):
        ms.mamba_scan_fused(dt, x, a, b, c, bias, d_skip[:3], z)


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_fake_implementation_gives_the_gated_output(dtype, return_state):
    """Under `FakeTensorMode` the fused call runs the custom op's fake
    implementation: y [B,S,Di] in x's dtype, h_S [B,Di,N] (or [0]) fp32; no
    launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    before = ms.launches, ms.kernel_launches["fused"]
    with FakeTensorMode() as mode:
        ins = [mode.from_tensor(t) for t in _gated_inputs(5, 2, 24, 16, 8, getattr(torch, dtype))]
        y, h = torch.ops.repro_torch.mamba_scan_fused(*ins, return_state)
        assert isinstance(y, FakeTensor) and isinstance(h, FakeTensor)
        assert y.shape == (2, 24, 16) and y.dtype == getattr(torch, dtype)
        assert h.shape == ((2, 16, 8) if return_state else (0,)) and h.dtype == torch.float32
        out = ms.mamba_scan_fused(*ins, return_state=return_state)
        out_y = out[0] if return_state else out
        assert out_y.shape == y.shape and out_y.dtype == y.dtype
    assert (ms.launches, ms.kernel_launches["fused"]) == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_apply_ssm_kernel_path_gives_the_ungated_output_and_state(arch, dtype, monkeypatch):
    """`apply_ssm`'s kernel path under no_grad takes the fused call, once, and on
    the CPU gives the unfused mixer's output and state bit for bit: the plain
    scan on softplus(dt + dt_bias), then y + x·D, the cast, the gate and
    out_proj as separate ops."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import mamba_scan_fused_ref
    cfg, _, _, p = _setup(arch, dtype)
    lp = p["layers"][0]["ssm"]
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x = x.to(getattr(torch, dtype))
    calls = _record_fused_calls(monkeypatch)
    with torch.no_grad():
        out, state = ssm.apply_ssm(cfg, lp, x, return_state=True)
        assert calls == [True]
        dt = x.dtype
        x_in, z = (x @ lp["in_proj"].to(dt)).chunk(2, dim=-1)
        xc = F.silu(ssm._conv1d_causal(cfg, lp, x_in))
        delta, a, b, c = ssm._ssm_params(cfg, lp, xc)
        y, h = mamba_scan_fused_ref(delta, xc, a, b, c, return_state=True)
        y = y + xc.float() * lp["d_skip"].float()
        want = (y.to(dt) * F.silu(z)) @ lp["out_proj"].to(dt)
    assert torch.equal(out, want) and torch.equal(state["ssm"], h)
    assert torch.equal(state["conv"], x_in[:, -(cfg.d_conv - 1):].float())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_takes_the_gated_call_per_layer_and_training_none(arch, monkeypatch):
    """A prefill makes one fused call per SSM layer; its step record keeps
    `mamba_scan/fused`, 0 here since the CPU runs the plain version (on
    the card it counts the same calls: `tests/test_torch_cuda.py`).  A train
    step, which autograd records, makes none and counts 0."""
    from repro_torch import scope
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    cfg, _, _, p = _setup(arch, "float32")
    calls = _record_fused_calls(monkeypatch)
    batch = api.demo_batch(cfg, 2, 12, device="cpu")
    make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=16)(p, batch)
    assert calls == [True] * cfg.num_layers
    assert scope.steps[-1].counters["mamba_scan/fused"] == 0
    calls.clear()
    opt_cfg = adamw.AdamWConfig()
    params = tree_map(lambda t: t.float(), p)
    make_train_step(cfg, opt_cfg, StepSettings(accum=2, remat="dots"))(
        params, adamw.init(opt_cfg, params), api.demo_batch(cfg, 4, 16, device="cpu"))
    rec = scope.steps[-1]
    assert rec.kind == "train" and rec.counters["mamba_scan/fused"] == 0
    assert calls == []


def test_fake_prefill_takes_the_gated_op_and_counts_nothing(monkeypatch):
    """A falcon-mamba-7b prefill at full width and 2 layers (2 x 64) on fake
    tensors: every layer's scan is a fused call through the custom op's fake
    implementation, no launch is counted and the record's fused launches are 0."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch import scope
    cfg = get_config("falcon-mamba-7b").replace(num_layers=2)
    calls = _record_fused_calls(monkeypatch)
    before = ms.launches, ms.kernel_launches["fused"]
    batch = api.demo_batch(cfg, 2, 64, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                          api.abstract_params(cfg, torch.bfloat16))
        lg, _ = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=65)(
            params, batch)
        assert isinstance(lg, FakeTensor)
    assert calls == [True] * cfg.num_layers
    assert (ms.launches, ms.kernel_launches["fused"]) == before
    assert scope.steps[-1].counters["mamba_scan/fused"] == 0


_MESH_PREFILL = """
import json
from repro_torch import scope
from repro_torch.kernels import mamba_scan as ms
from repro_torch.launch.dryrun import lower_cell
calls = []
real = ms.mamba_scan_fused
ms.mamba_scan_fused = lambda *a, **k: calls.append(len(a) == 8) or real(*a, **k)
lower_cell("falcon-mamba-7b", "prefill_32k", device="cpu", cfg_overrides={"num_layers": 2})
print("FUSED" + json.dumps([calls, scope.steps[-1].counters["mamba_scan/fused"]]))
"""


def test_mesh_prefill_takes_the_fused_call_on_each_rank():
    """A falcon-mamba-7b prefill (2 layers, 32k) on DTensors, as rank 0 of the
    production mesh under the fake process group on fake tensors (the
    dry-run's): each layer's scan runs per rank as the fused call, its gate's
    arguments placed as A and x, and the step record counts no launch."""
    import json
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(tests), "src"),
           "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", _MESH_PREFILL], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    calls, counted = json.loads(next(l for l in res.stdout.splitlines()
                                     if l.startswith("FUSED"))[len("FUSED"):])
    assert calls == [True, True] and counted == 0


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
    """`ref.scan_inloop` against `scan_chunked` on `_discretise`'s a_bar and bx:
    y and the final state equal bit for bit (the discretisation is elementwise),
    and the gradients of delta, x, A, B and C within 2e-5 (A's sums its
    chunks' parts in another order)."""
    ins = _inloop_inputs(S, 2, S, 16, 4)
    w = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 16)).astype(np.float32))
    got = []
    for inloop in (True, False):
        live = [t.clone().requires_grad_() for t in ins]
        if inloop:
            y, h = ref.scan_inloop(*live, return_state=True, chunk=chunk)
        else:
            delta, x, a, b, c = live
            y, h = ref.scan_chunked(*ref._discretise(delta, x, a, b), c, return_state=True,
                                    chunk=chunk)
        ((y * w).sum() + h.sum()).backward()
        got.append((y, h, [t.grad for t in live]))
    (y, h, grads), (y0, h0, want) = got
    assert torch.equal(y, y0) and torch.equal(h, h0)
    for g, g0 in zip(grads, want):
        assert rel_err(to_np(g), to_np(g0)) < 2e-5


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
        out, saved = _saved_bytes(lambda: ssm.apply_ssm(cfg.replace(ssm_inloop=flag), live, x))
        assert (saved < one) if flag else (saved >= one), (flag, saved, one)
        out.square().mean().backward()
        grads[flag] = {k: v.grad for k, v in live.items()}
    for k in p:
        assert rel_err(to_np(grads[True][k]), to_np(grads[False][k])) < 2e-5, k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inloop_forward_loss_and_gradients_match_reference(arch):
    """With `ssm_inloop` in both packages, fp32, 2 x 320 (5 chunks of 64):
    logits, the training loss and every parameter's gradient through the
    CPU's plain scan against the reference's forward, loss_fn and jax.grad,
    within 2e-5."""
    cfg, jcfg, jp, _ = model_pair(arch, "float32", ssm_inloop=True)
    p = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu", dtype=torch.float32)
    batch, jbatch = batch_pair(cfg, 2, 320)
    with torch.no_grad():
        lg, _ = api.forward(cfg, p, batch, attn_impl="naive")
    jlg, _ = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    assert rel_err(to_np(lg), jlg) < TOL["float32"]
    live = tree_map(lambda t: t.detach().requires_grad_(), p)
    loss = api.loss_fn(cfg, live, batch, remat="dots")
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


# --------------------------------------------------------------------------
# K2's training entry point: its plain models, its CPU path, its fake ops
# --------------------------------------------------------------------------

def _train_inputs(seed, B, S, Di, N, dtype=torch.float64):
    return [t.to(dtype) for t in _inloop_inputs(seed, B, S, Di, N)]


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("S", [1, 7, 300])
def test_train_scan_plain_models_match_autograd_through_the_inloop_scan(S, N, return_state):
    """The training kernels' plain models (`ref.mamba_scan_train_ref`, then
    `mamba_scan_train_bwd_ref` stepping each chunk of `train_chunk(N)` steps
    backwards from its recomputed states; 300 is no multiple of the chunk and
    1 and 7 are under it) against `scan_inloop` and autograd through it, in
    float64: y, h_S, and the gradients of delta, x, A, B and C of a weighted
    sum of y (and of h_S, when it is returned) within 1e-12 of the largest."""
    from repro_torch.kernels import ref
    B, Di = 2, 6
    ins = _train_inputs(S * N, B, S, Di, N)
    rng = np.random.default_rng(S + N)
    dy = torch.from_numpy(rng.standard_normal((B, S, Di)))
    dh = torch.from_numpy(rng.standard_normal((B, Di, N))) if return_state else None
    live = [t.clone().requires_grad_() for t in ins]
    y, h = ref.scan_inloop(*live, return_state=True)
    loss = (y * dy).sum() + ((h * dh).sum() if return_state else 0)
    want = torch.autograd.grad(loss, live, materialize_grads=True)
    y2, h2, states = ref.mamba_scan_train_ref(*ins)
    chunk = ref.train_chunk(N)
    assert states.shape == (B, -(-S // chunk), Di, N) and S % chunk != 0
    got = ref.mamba_scan_train_bwd_ref(*ins, states, dy, dh)
    for name, a, b in zip(("y", "h", "ddelta", "dx", "dA", "dB", "dC"), (y2, h2, *got),
                          (y, h, *want)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        b = b.detach()
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0), name


def test_train_chunk_keeps_a_warp_s_states_in_32_kb():
    """`train_chunk(N)`: min(32, 256 / P), P = N rounded up to a power of two
    (at least 4), so that chunk x P x 32 channels of fp32 states are 32 KB or
    less (csrc/mamba_scan_train.cu's chunk_of)."""
    from repro_torch.kernels import ref
    assert [ref.train_chunk(n) for n in (1, 4, 5, 8, 9, 16, 17, 32)] == [32, 32, 32, 32, 16,
                                                                          16, 8, 8]
    for n in range(1, ms.MAX_STATE + 1):
        p = 1 << max(2, (n - 1).bit_length())
        assert ref.train_chunk(n) * p * 32 * 4 <= 32 * 1024


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_train_entry_on_cpu_is_the_inloop_scan_bit_for_bit(x_dtype):
    """`mamba_scan_train` on CPU tensors is `scan_inloop` on x widened to fp32:
    y, h_S and the gradients of every input (x's in x's dtype) equal bit for
    bit, and no launch is counted."""
    delta, x, a, b, c = _inloop_inputs(3, 2, 100, 16, 16)
    x = x.to(getattr(torch, x_dtype))
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 100, 16)).astype(np.float32))
    before = ms.launches, dict(ms.kernel_launches)
    got = []
    for fn in (lambda *t: ops.mamba_scan_train(*t, return_state=True),
               lambda d, xx, *t: ref.scan_inloop(d, xx.float(), *t, return_state=True)):
        live = [t.clone().requires_grad_() for t in (delta, x, a, b, c)]
        y, h = fn(*live)
        got.append((y, h, torch.autograd.grad((y * w).sum() + h.sum(), live)))
    (y, h, grads), (y0, h0, want) = got
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert grads[1].dtype == x.dtype
    for g, g0 in zip(grads, want):
        assert torch.equal(g, g0)
    assert (ms.launches, ms.kernel_launches) == before


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_train_ops_fake_implementations_give_the_kernels_shapes(x_dtype, return_state):
    """Under `FakeTensorMode` the training entry point runs its custom ops'
    fake implementations, forward and backward: y [B,S,Di] and h_S [B,Di,N]
    (or [0]) fp32, the saved states [B, ceil(S / chunk), Di, N] fp32, and
    gradients in their inputs' shapes and dtypes (x's in x's); no launch."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    B, S, Di, N = 2, 40, 24, 16
    before = ms.launches, dict(ms.kernel_launches)
    with FakeTensorMode():
        delta, a = torch.rand(B, S, Di), -torch.rand(Di, N)
        x = torch.randn(B, S, Di, dtype=getattr(torch, x_dtype))
        b, c = torch.randn(B, S, N), torch.randn(B, S, N)
        y, h, states = torch.ops.repro_torch.mamba_scan_train(delta, x, a, b, c, return_state)
        assert all(isinstance(t, FakeTensor) for t in (y, h, states))
        assert y.shape == (B, S, Di) and y.dtype == torch.float32
        assert h.shape == ((B, Di, N) if return_state else (0,)) and h.dtype == torch.float32
        assert states.shape == (B, -(-S // ref.train_chunk(N)), Di, N)
        live = [t.requires_grad_() for t in (delta, x, a, b, c)]
        out = ms.mamba_scan_train(*live, return_state=return_state)
        y = out[0] if return_state else out
        grads = torch.autograd.grad(y.sum(), live)
        for g, t in zip(grads, live):
            assert isinstance(g, FakeTensor) and g.shape == t.shape and g.dtype == t.dtype
    assert (ms.launches, ms.kernel_launches) == before


def test_fake_train_step_runs_through_the_training_op(monkeypatch):
    """A falcon-mamba-7b train step at full width and 2 layers (2 x 64, accum
    2, remat "dots") on fake tensors: every layer's scan goes through K2's
    training entry point, once in each micro-batch's forward and again in its
    remat's recompute, and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = get_config("falcon-mamba-7b").replace(num_layers=2)
    calls = []
    real = ms.mamba_scan_train
    monkeypatch.setattr(ms, "mamba_scan_train", lambda *a, **k: calls.append(1) or real(*a, **k))
    before = ms.launches, dict(ms.kernel_launches)
    batch = api.demo_batch(cfg, 2, 64, device="cpu")
    opt_cfg = adamw.AdamWConfig()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                          api.abstract_params(cfg, torch.float32))
        opt = adamw.init(opt_cfg, params)
        step = make_train_step(cfg, opt_cfg, StepSettings(accum=2, remat="dots"))
        params, opt, metrics = step(params, opt, batch)
        assert isinstance(metrics["loss"], FakeTensor)
    assert len(calls) == cfg.num_layers * 2 * 2
    assert (ms.launches, ms.kernel_launches) == before


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cpu_training_through_the_kernel_path_is_the_plain_path(arch, monkeypatch):
    """On real CPU tensors a loss under autograd (the train step's) takes the
    plain scan, flag off and on: it calls neither K2 entry point, counts no
    launch, and its loss and every gradient equal bit for bit those with the
    mixer's scan taken explicitly through `ref.scan_chunked`, or
    `ref.scan_inloop` under `ssm_inloop` (remat "dots", fp32)."""
    cfg, _, _, p = _setup(arch, "float32")
    batch = api.demo_batch(cfg, 2, 24, device="cpu")
    for inloop in (False, True):
        assert_cpu_training_takes_the_plain_scan(cfg.replace(ssm_inloop=inloop), p, batch,
                                                 monkeypatch, remat="dots")
