"""The CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Each test skips where torch.cuda.is_available() is false.
"""
import json

import pytest
import torch

from _torch_parity import FLASH_CASES, MAMBA_CASES, max_abs_err, qkv, scan_inputs, to_np
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, mamba_scan_ref
from repro_torch.models import api, ssm
from repro_torch.models.attention import attend_naive


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,D,causal,window,dtype,tol", FLASH_CASES)
def test_kernel_matches_plain_version(B, H, K, S, D, causal, window, dtype, tol):
    _need_card()
    (q, _), (k, _), (v, _) = qkv(S + D, B, H, K, S, S, D, dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert max_abs_err(to_np(out), to_np(ref)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset,Dh,Sq,Skv", [(128, 128, 128, 256), (0, 120, 100, 100),
                                                (7, 64, 33, 70)])
def test_kernel_model_layout_offsets_and_ragged_tiles(q_offset, Dh, Sq, Skv):
    """Strided [B,S,H,Dh] views, head dims that are not 128, q_offset, partial tiles."""
    _need_card()
    (q, _), (k, _), (v, _) = qkv(Dh, 2, 4, 2, Sq, Skv, Dh, "float32")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    for window in (0, 16):
        out = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
        ref = flash_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
        assert max_abs_err(to_np(out), to_np(ref)) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 48])
def test_kernel_bf16_head_dim_64_model_layout(window):
    """The bf16 build for head dim 64 that hybrid models run, 5:1 GQA, in the model
    layout; each output within two bf16 rounding steps of the plain version's."""
    _need_card()
    (q, _), (k, _), (v, _) = qkv(64 + window, 2, 5, 1, 200, 200, 64, "bfloat16")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    out = fa.flash_attention(q, k, v, causal=True, window=window).float()
    ref = flash_attention_ref(q, k, v, causal=True, window=window).float()
    assert bool(((out - ref).abs() <= 2 * (2.0 ** -7 * ref.abs() + 1e-5)).all())
    assert max_abs_err(to_np(out), to_np(ref)) < 3e-2


# the tensor-core kernel (bf16, every head dim) in the model layout: B, H, K, Sq, Skv,
# D, window, q_offset.  S not a multiple of 128 (of 64 at D > 128, whose KV tiles hold
# 64 keys), q_offset > 0, window edges inside a tile, D in {64, 120, 128, 192, 256}
# (192 zero-padded to 256 by TMA), G = H / K in {1, 2, 5, 16}
TENSOR_CORE_CASES = [
    (1, 4, 4, 100, 100, 128, 0, 0),
    (2, 5, 1, 1000, 1000, 64, 300, 0),
    (1, 16, 1, 1000, 1000, 128, 0, 0),
    (1, 4, 2, 122, 250, 120, 0, 128),
    (1, 5, 5, 256, 256, 64, 77, 0),
    (1, 16, 1, 40, 300, 64, 50, 260),
    (2, 10, 2, 333, 333, 120, 200, 0),
    (1, 8, 4, 333, 333, 256, 0, 0),
    (2, 4, 2, 122, 250, 256, 77, 128),
    (1, 4, 4, 300, 300, 192, 100, 0),
    (1, 8, 4, 40, 301, 192, 50, 261),
]


def _bf16_within_two_steps(out, ref):
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= 2 * (2.0 ** -7 * ref.abs() + 1e-5)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,Sq,Skv,D,window,q_offset", TENSOR_CORE_CASES)
def test_tensor_core_kernel_matches_plain_version(B, H, K, Sq, Skv, D, window, q_offset):
    _need_card()
    (q, _), (k, _), (v, _) = qkv(Sq + D + window, B, H, K, Sq, Skv, D, "bfloat16")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.kernel_launches == dict(before, tensor_core=before["tensor_core"] + 1)
    ref = flash_attention_ref(q, k, v, **kw)
    assert _bf16_within_two_steps(out, ref)
    assert max_abs_err(to_np(out), to_np(ref)) < 3e-2


@pytest.mark.cuda
def test_bf16_wide_heads_run_on_the_tensor_cores():
    _need_card()
    (q, _), (k, _), (v, _) = qkv(7, 1, 4, 2, 256, 256, 256, "bfloat16")
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.kernel_launches == dict(before, tensor_core=before["tensor_core"] + 1)
    assert _bf16_within_two_steps(out, flash_attention_ref(q, k, v, causal=True))


@pytest.mark.cuda
def test_fp32_wide_heads_run_on_the_tensor_cores_in_3xtf32():
    """fp32 at head dim 256 runs the 3xTF32 tensor-core kernel and meets 2e-5."""
    _need_card()
    (q, _), (k, _), (v, _) = qkv(8, 1, 4, 2, 200, 200, 256, "float32")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v, causal=True, window=70)
    torch.cuda.synchronize()
    assert fa.kernel_launches == dict(before, tensor_core_fp32=before["tensor_core_fp32"] + 1)
    ref = flash_attention_ref(q, k, v, causal=True, window=70)
    assert max_abs_err(to_np(out), to_np(ref)) < 2e-5


@pytest.mark.cuda
def test_views_tma_cannot_load_raise_and_launch_nothing():
    """A bf16 call the tensor-core kernel cannot take raises with the reason; it never
    runs the fp32 kernel instead."""
    _need_card()
    base = torch.randn(1, 64, 4, 136, device="cuda").bfloat16()
    shifted = base[..., 1:129].transpose(1, 2)               # base 2 bytes past alignment
    narrow = torch.empty(1, 64, 4, 124, device="cuda").bfloat16()[..., :120].transpose(1, 2)
    good = base[..., :128].contiguous().transpose(1, 2)
    before = fa.launches, dict(fa.kernel_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(shifted, good, good)
    with pytest.raises(ValueError, match="not a multiple of 16 bytes"):
        fa.flash_attention(narrow, narrow, narrow)
    assert (fa.launches, fa.kernel_launches) == before


@pytest.mark.cuda
def test_model_flash_prefill_matches_naive_on_card():
    _need_card()
    cfg = smoke_config(get_config("chatglm3-6b"))
    p = api.init_params(cfg, 0)
    batch = api.demo_batch(cfg, 2, 80)
    before = fa.launches
    lg, cache = api.prefill(cfg, p, batch, attn_impl="flash", cache_len=96)
    assert fa.launches == before + cfg.num_layers
    ref_lg, ref_cache = api.prefill(cfg, p, batch, attn_impl="naive", cache_len=96)
    scale = float(ref_lg.float().abs().max())
    assert float((lg.float() - ref_lg.float()).abs().max()) / scale < 0.02
    q = torch.randn(1, 16, 4, 16, device="cuda")
    k = torch.randn(1, 16, 2, 16, device="cuda")
    out = ops.flash_attention(cfg, q, k, k, causal=True)
    assert max_abs_err(to_np(out), to_np(attend_naive(cfg, q, k, k))) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N", [c[:4] for c in MAMBA_CASES]
                         + [(2, 37, 24, 5), (1, 7, 40, 32), (3, 0, 8, 16)])
def test_scan_kernel_matches_plain_version(B, S, Di, N):
    """The reference's cases (abs 1e-4), plus N that is not a power of two, N = 32,
    a ragged Di and an empty sequence (final state 0)."""
    _need_card()
    a, bx, c = (torch.from_numpy(t).cuda() for t in scan_inputs(S + Di + N, B, S, Di, N))
    before = ms.launches
    y, h = ms.mamba_scan(a, bx, c, return_state=True)
    y_only = ms.mamba_scan(a, bx, c)
    torch.cuda.synchronize()
    assert ms.launches == before + 2
    ref_y, ref_h = mamba_scan_ref(a, bx, c, return_state=True)
    assert y.shape == (B, S, Di) and h.shape == (B, Di, N)
    if S:
        assert max_abs_err(to_np(y), to_np(ref_y)) < 1e-4
    assert max_abs_err(to_np(h), to_np(ref_h)) < 1e-4
    assert torch.equal(y, y_only)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_model_prefill_launches_the_scan_once_per_layer_on_card(arch):
    _need_card()
    cfg = smoke_config(get_config(arch)).replace(compute_dtype="float32")
    p = api.init_params(cfg, 0)
    batch = api.demo_batch(cfg, 2, 40)
    before, fused = (ms.launches, fa.launches), ms.kernel_launches["fused"]
    lg, cache = api.prefill(cfg, p, {"tokens": batch["tokens"][:, :-1]}, attn_impl="flash",
                            cache_len=48)
    n_attn = cfg.num_layers if cfg.family == "hybrid" else 0
    assert (ms.launches, fa.launches) == (before[0] + cfg.num_layers, before[1] + n_attn)
    assert ms.kernel_launches["fused"] == fused + cfg.num_layers    # the fused entry point
    full, _ = api.forward(cfg, p, batch, attn_impl="naive")
    dec, _ = api.decode_step(cfg, p, cache, batch["tokens"][:, -1:], 39)
    scale = float(full[:, -1].abs().max())
    assert float((dec[:, 0] - full[:, -1]).abs().max()) / scale < 2e-5


def _fused_inputs(seed, B, S, Di, N, x_dtype):
    """delta = softplus(z - 1), A = -(1..N) per channel times exp(0.1 z), x, B, C = z."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    delta = torch.nn.functional.softplus(z(B, S, Di) - 1.0)
    a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32) * (0.1 * z(Di, N)).exp()
    return delta, z(B, S, Di).to(getattr(torch, x_dtype)), a, z(B, S, N), z(B, S, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N,chunked", [
    (1, 128, 64, 8, False), (2, 256, 128, 16, True), (1, 96, 64, 4, False),
    (1, 1000, 96, 16, True), (2, 300, 64, 5, True), (3, 513, 100, 32, True),
    (2, 37, 24, 16, False), (4, 512, 8192, 16, False), (3, 0, 8, 16, False)])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_fused_scan_kernel_matches_plain_version(B, S, Di, N, chunked, x_dtype):
    """K2's fused entry point against its plain version (the discretisation, then
    the sequential scan), y and h_S within 1e-4: shapes that take the chunked-time
    branch on an H100's 132 SMs (small B x Di: several chunks, S not a multiple of
    the chunk) and shapes that do not, N not a power of two, an empty sequence."""
    assert (ms.scan_chunks(B, S, Di, N, 132) > 1) == chunked
    _need_card()
    ins = _fused_inputs(S + Di + N, B, S, Di, N, x_dtype)
    before = ms.kernel_launches["fused"]
    y, h = ms.mamba_scan_fused(*ins, return_state=True)
    y_only = ms.mamba_scan_fused(*ins)
    torch.cuda.synchronize()
    assert ms.kernel_launches["fused"] == before + 2
    ref_y, ref_h = ms.mamba_scan_fused_ref(*ins, return_state=True)
    assert y.shape == (B, S, Di) and h.shape == (B, Di, N)
    if S:
        assert max_abs_err(to_np(y), to_np(ref_y)) < 1e-4
    assert max_abs_err(to_np(h), to_np(ref_h)) < 1e-4
    assert torch.equal(y, y_only)


@pytest.mark.cuda
def test_fused_scan_fake_implementation_matches_the_kernel_s_outputs():
    from torch._subclasses.fake_tensor import FakeTensorMode
    _need_card()
    ins = _fused_inputs(0, 2, 64, 32, 8, "bfloat16")
    real = ms.mamba_scan_fused(*ins, return_state=True)
    count = ms.launches
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = ms.mamba_scan_fused(*(mode.from_tensor(t) for t in ins), return_state=True)
    assert ms.launches == count
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride(), f.device) == (r.shape, r.dtype, r.stride(), r.device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N", [(1, 1000, 96, 16), (2, 256, 128, 16), (1, 128, 64, 8),
                                      (4, 512, 8192, 16)])
def test_fused_scan_counts_its_chunks_of_time(B, S, Di, N):
    """`mamba_scan.chunks` adds each fused call's chunks of time: more than 1 in
    the chunked-time branch, 1 for a call that takes one pass."""
    _need_card()
    parts = ms.scan_chunks(B, S, Di, N, torch.cuda.get_device_properties(0).multi_processor_count)
    parts = -(-S // -(-S // parts))           # as many as the chunk's length leaves
    ins = _fused_inputs(B + S, B, S, Di, N, "bfloat16")
    before = ms.chunks, ms.launches
    ms.mamba_scan_fused(*ins)
    torch.cuda.synchronize()
    assert (ms.chunks, ms.launches) == (before[0] + parts, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "falcon-mamba-7b"])
def test_prefill_step_record_carries_the_kernel_launches(arch):
    """The prefill step's record keeps K1's and K2's launches over the call, as
    the benchmark's k1_roofline and k2_roofline count them: one a layer."""
    from repro_torch import scope
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_prefill_step
    _need_card()
    cfg = smoke_config(get_config(arch))
    p = api.init_params(cfg, 0)
    step = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=65)
    step(p, api.demo_batch(cfg, 2, 64))
    rec = scope.steps[-1]
    k1, k2 = (cfg.num_layers, 0) if arch == "chatglm3-6b" else (0, cfg.num_layers)
    assert (rec.kind, rec.rows, rec.length) == ("prefill", 2, 64)
    assert rec.counters["flash_attention.launches"] == k1
    assert rec.counters["mamba_scan.launches"] == k2
    assert rec.counters["mamba_scan.chunks"] >= k2
    assert rec.spans["layer"][0] == cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch,windows", [("hymba-1.5b", (16, 0, 16)), ("chatglm3-6b", ())])
def test_prefill_step_record_counts_k1_window_launches(arch, windows):
    """`flash_attention.window_launches` counts the K1 launches of a prefill's
    windowed layers, as the benchmark's k1_roofline.hybrid checks them: 2 of a
    smoke hymba-1.5b's 3 layers (a global one between two of window 16, on
    prompts longer than the window), none of chatglm3-6b's.  The step record
    carries the change."""
    from repro_torch import scope
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_prefill_step
    _need_card()
    cfg = smoke_config(get_config(arch))
    if windows:
        cfg = cfg.replace(num_layers=len(windows), window_pattern=windows)
    p = api.init_params(cfg, 0)
    step = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=65)
    before = fa.window_launches
    step(p, api.demo_batch(cfg, 2, 64))
    torch.cuda.synchronize()
    rec = scope.steps[-1]
    n = sum(w > 0 for w in windows)
    assert fa.window_launches == before + n
    assert rec.counters["flash_attention.window_launches"] == n
    assert rec.counters["flash_attention.launches"] == cfg.num_layers


# fp32 head dims the 3xTF32 kernel pads to 64, 128 and 256, with and without a window
# and a q_offset: B, H, K, Sq, Skv, D, window, q_offset
FP32_CASES = [(2, 4, 2, Sq, Skv, D, w, off) for D in (64, 120, 128, 192, 256)
              for Sq, Skv, w, off in ((300, 300, 0, 0), (257, 257, 70, 0), (128, 200, 48, 72))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,Sq,Skv,D,window,q_offset", FP32_CASES)
def test_fp32_tensor_core_kernel_matches_plain_version(B, H, K, Sq, Skv, D, window, q_offset):
    """fp32 in 3xTF32 in the model layout, causal, at every padded head dim, with a
    window and a q_offset: max abs 2e-5, one tensor_core_fp32 launch each."""
    _need_card()
    (q, _), (k, _), (v, _) = qkv(D + Sq, B, H, K, Sq, Skv, D, "float32")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    before = fa.kernel_launches["tensor_core_fp32"]
    out = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.kernel_launches["tensor_core_fp32"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=True, window=window, q_offset=q_offset)
    assert max_abs_err(to_np(out), to_np(ref)) < 2e-5


# the new serving paths' K1 shapes, cut in batch and heads to keep the plain
# version small: B, H, K, S, D, window.  danube's head dim 120 is read unpadded
# (TMA fills the tile's rest with zeros); its and mixtral's window of 4096 masks
# only past S = 4096; gemma3's head dim 256 runs the tensor-core kernel at 64 keys a
# KV tile
PATH_CASES = [
    (1, 8, 2, 4352, 120, 4096),     # h2o-danube-3-4b
    (1, 6, 1, 4352, 128, 4096),     # mixtral-8x22b
    (1, 8, 4, 2048, 256, 1024),     # gemma3-4b, local layers
    (1, 8, 4, 2048, 256, 0),        # gemma3-4b, global layers
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,S,D,window", PATH_CASES)
def test_new_path_shapes_meet_the_path_limits(B, H, K, S, D, window):
    """bf16, causal, model layout: max abs < 1e-2 and every element within two
    bf16 rounding steps of the plain version, on the kernel `kernel_for` names."""
    _need_card()
    (q, _), (k, _), (v, _) = qkv(S + D + window, B, H, K, S, S, D, "bfloat16")
    q, k, v = (t.cuda().transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    kernel = fa.kernel_for(torch.bfloat16, D)
    assert kernel == "tensor_core"
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.kernel_launches == dict(before, **{kernel: before[kernel] + 1})
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    assert _bf16_within_two_steps(out, ref)
    assert max_abs_err(to_np(out), to_np(ref)) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma3-4b", "qwen2-vl-2b",
                                  "mixtral-8x22b", "qwen3-moe-235b-a22b", "llama3-405b"])
def test_new_arch_prefill_launches_k1_once_per_layer_on_card(arch):
    """The smoke config's flash prefill: in bf16, one K1 launch per layer, all on
    the kernel `kernel_for` names for its head dim; in fp32 compute, logits within
    2e-5 of the naive prefill's.  (In bf16 the two prefills' rounding can tip a
    MoE router's choice or drop, a discrete difference; fp32 holds them all.)"""
    _need_card()
    for dtype in ("bfloat16", "float32"):
        cfg = smoke_config(get_config(arch)).replace(compute_dtype=dtype)
        p = api.init_params(cfg, 0)
        batch = api.demo_batch(cfg, 2, 80)
        kernel = fa.kernel_for(getattr(torch, dtype), cfg.head_dim)
        before = fa.launches, dict(fa.kernel_launches)
        lg, _ = api.prefill(cfg, p, batch, attn_impl="flash", cache_len=96)
        torch.cuda.synchronize()
        assert fa.launches == before[0] + cfg.num_layers
        assert fa.kernel_launches == dict(before[1],
                                          **{kernel: before[1][kernel] + cfg.num_layers})
        assert bool(torch.isfinite(lg).all())
    ref_lg, _ = api.prefill(cfg, p, batch, attn_impl="naive", cache_len=96)
    scale = float(ref_lg.abs().max())
    assert float((lg - ref_lg).abs().max()) / scale < 2e-5


@pytest.mark.cuda
def test_kernel_wrappers_raise_under_autograd_on_card():
    """Neither kernel has a backward: with grad mode on and a CUDA input that
    requires grad, each wrapper raises and launches nothing; under no_grad it runs."""
    _need_card()
    q = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    a = torch.rand(1, 16, 8, 4, device="cuda", requires_grad=True)
    bx, c = torch.randn(1, 16, 8, 4, device="cuda"), torch.randn(1, 16, 4, device="cuda")
    before = fa.launches, ms.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ms.mamba_scan(a, bx, c)
    assert (fa.launches, ms.launches) == before
    with torch.no_grad():
        fa.flash_attention(q, k, k)
        ms.mamba_scan(a, bx, c)
    torch.cuda.synchronize()
    assert (fa.launches, ms.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "hymba-1.5b"])
def test_smoke_train_step_on_card_launches_no_kernel(arch):
    """One make_train_step(accum=2, remat="dots") step on the card from fp32
    master weights: finite loss and grad norm, count 1, params moved, and no
    forward-only kernel launched (the train path runs naive attention); the
    hybrid's scan runs K2's training pair, twice forward (the forward and the
    remat's recompute) and once backward per layer and micro-batch.  Then the
    flash eval step launches K1 (and, for the hybrid, the fused K2) once per
    layer."""
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.optim import adamw
    _need_card()
    cfg = smoke_config(get_config(arch))
    params = api.init_params(cfg, 0, dtype=torch.float32)
    before_params = [t.clone() for t in _param_leaves(params)]
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = api.demo_batch(cfg, 4, 32)
    step = make_train_step(cfg, opt_cfg, StepSettings(accum=2, remat="dots"))
    before = fa.launches, ms.launches, dict(ms.kernel_launches)
    params, opt, metrics = step(params, adamw.init(opt_cfg, params), batch)
    torch.cuda.synchronize()
    n_scan = cfg.num_layers if cfg.family == "hybrid" else 0
    assert (fa.launches, ms.launches) == (before[0], before[1] + 3 * 2 * n_scan)
    assert ms.kernel_launches == dict(before[2], train_fwd=before[2]["train_fwd"] + 4 * n_scan,
                                      train_bwd=before[2]["train_bwd"] + 2 * n_scan)
    assert bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert int(opt["count"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before_params, _param_leaves(params)))
    before = fa.launches, ms.launches
    flash = make_eval_step(cfg, StepSettings(attn_impl="flash"))(params, batch)
    torch.cuda.synchronize()
    assert (fa.launches, ms.launches) == (before[0] + cfg.num_layers, before[1] + n_scan)
    naive = make_eval_step(cfg, StepSettings(attn_impl="naive"))(params, batch)
    assert abs(float(flash) - float(naive)) / float(naive) < 0.02


@pytest.mark.cuda
def test_inloop_train_step_on_card_equals_the_flag_off_step():
    """A smoke falcon-mamba-7b make_train_step(accum=2, remat="dots") at 4 x 512
    from the same fp32 weights with `ssm_inloop` off and on: the flag leaves
    the kernel path as it is, so both run K2's training pair (3 launches a
    layer and micro-batch) and give the same loss and grad norm bit for bit."""
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    _need_card()
    cfg = smoke_config(get_config("falcon-mamba-7b"))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = api.demo_batch(cfg, 4, 512)
    before = fa.launches, ms.launches
    out = {}
    for flag in (False, True):
        params = api.init_params(cfg, 0, dtype=torch.float32)
        c = cfg.replace(ssm_inloop=flag)
        _, _, m = make_train_step(c, opt_cfg, StepSettings(accum=2, remat="dots"))(
            params, adamw.init(opt_cfg, params), batch)
        out[flag] = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    assert (fa.launches, ms.launches) == (before[0], before[1] + 2 * 3 * 2 * cfg.num_layers)
    assert out[True] == out[False]


def _train_scan_inputs(seed, B, S, Di, N, x_dtype):
    """`_fused_inputs`' draws with delta = softplus(z - 3), nearer the models' time steps."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    delta = torch.nn.functional.softplus(z(B, S, Di) - 3.0)
    a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32) * (0.1 * z(Di, N)).exp()
    return [delta, z(B, S, Di).to(getattr(torch, x_dtype)), a, z(B, S, N), z(B, S, N)]


def _grads(fn, ins, dy, dh):
    live = [t.clone().requires_grad_() for t in ins]
    y, h = fn(*live)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), live, materialize_grads=True)
    return [y.detach(), h.detach(), *grads]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N", [
    (2, 2048, 8192, 16),     # falcon-mamba-7b's train micro-batch (4 x 2048, accum 2)
    (4, 2048, 3200, 16),     # hymba-1.5b's
    (2, 2048, 800, 16),      # hymba-1.5b's on a rank of model 4
    (2, 1, 64, 16), (2, 300, 96, 16), (1, 300, 40, 4)])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_train_scan_pair_matches_the_inloop_scan_on_card(B, S, Di, N, x_dtype):
    """K2's training pair (`mamba_scan_train`, its backward through autograd)
    against `scan_inloop` on x widened to fp32, on the card: y, h_S and the
    gradients of delta, A, B and C of a weighted sum of y and h_S within 2e-5
    of the largest (another order of sums), x's within a bf16 step (2^-7) of
    the largest where x is bf16 (2e-5 in fp32); two runs equal bit for bit (no
    atomics); one forward and one backward launch counted a run."""
    _need_card()
    ins = _train_scan_inputs(B + S + Di, B, S, Di, N, x_dtype)
    g = torch.Generator(device="cuda").manual_seed(S)
    dy = torch.randn((B, S, Di), generator=g, device="cuda")
    dh = torch.randn((B, Di, N), generator=g, device="cuda")
    before = ms.launches, dict(ms.kernel_launches), ms.backward_launches
    got = _grads(lambda *t: ms.mamba_scan_train(*t, return_state=True), ins, dy, dh)
    again = _grads(lambda *t: ms.mamba_scan_train(*t, return_state=True), ins, dy, dh)
    torch.cuda.synchronize()
    assert ms.launches == before[0] + 4 and ms.backward_launches == before[2] + 2
    assert ms.kernel_launches == dict(before[1], train_fwd=before[1]["train_fwd"] + 2,
                                      train_bwd=before[1]["train_bwd"] + 2)
    want = _grads(lambda d, x, *t: ssm.scan_inloop(d, x.float(), *t, return_state=True), ins,
                  dy, dh)
    names = ("y", "h", "ddelta", "dx", "dA", "dB", "dC")
    for name, a, b, c in zip(names, got, again, want):
        assert torch.equal(a, b), name
        assert a.shape == c.shape and a.dtype == c.dtype, name
        tol = 2 ** -7 if (name == "dx" and x_dtype == "bfloat16") else 2e-5
        err = float((a.float() - c.float()).abs().max() / c.float().abs().max().clamp_min(1e-30))
        assert err <= tol, (name, err)


@pytest.mark.cuda
def test_four_layer_falcon_mamba_train_step_meets_the_cell_limits_on_card():
    """4 of falcon-mamba-7b's layers at full width, one 2 x 2048 micro-batch, remat
    "dots", fp32 master weights: the loss and each leaf's gradient through K2's
    training pair against the plain scan's, by the train cell's gaps and
    limits (`perfbench/limits/falcon-mamba-7b-l4.train.json`: a leaf's gap is
    the norm of the difference over the larger of its norm and the median
    leaf's); two runs give equal gradients, bit for bit."""
    import os
    from repro_torch.models.meta import leaves, tree_map
    _need_card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "limits", "falcon-mamba-7b-l4.train.json")) as f:
        limits = json.load(f)
    cfg = get_config("falcon-mamba-7b").replace(num_layers=4)
    params = api.init_params(cfg, 0, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2048), generator=g, device="cuda")}

    def loss_and_grads(impl):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = api.loss_fn(cfg, live, batch, remat="dots", scan_impl=impl)
        return float(loss), torch.autograd.grad(loss, list(leaves(live)))
    before = ms.backward_launches
    loss, grads = loss_and_grads("kernel")
    loss2, grads2 = loss_and_grads("kernel")
    assert ms.backward_launches == before + 2 * cfg.num_layers
    assert loss == loss2 and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    loss0, grads0 = loss_and_grads("plain")
    assert abs(loss - loss0) / abs(loss0) <= limits["loss_gap"]
    norms = sorted(float(t.norm()) for t in grads0)
    median = norms[len(norms) // 2]
    for a, b in zip(grads, grads0):
        assert float((a - b).norm()) / max(float(b.norm()), median) <= limits["grad_gap"]


@pytest.mark.cuda
def test_train_step_record_counts_the_training_pair_on_card():
    """A 4-layer falcon-mamba-7b make_train_step(accum=2, remat="dots") (smoke
    widths): its step record carries 16 forward launches of K2's training
    pair (4 layers x 2 micro-batches, again in the remat's recompute) and 8
    backward ones (`mamba_scan.backward_launches`), no fused or K1 launch."""
    from repro_torch import scope
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    _need_card()
    cfg = smoke_config(get_config("falcon-mamba-7b")).replace(num_layers=4)
    params = api.init_params(cfg, 0, dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(cfg, opt_cfg, StepSettings(accum=2, remat="dots"))
    step(params, adamw.init(opt_cfg, params), api.demo_batch(cfg, 4, 256))
    torch.cuda.synchronize()
    rec = scope.steps[-1]
    assert rec.kind == "train"
    assert rec.counters == {"flash_attention.launches": 0,
                            "flash_attention.window_launches": 0, "mamba_scan.launches": 24,
                            "mamba_scan.chunks": 0, "mamba_scan.backward_launches": 8}


def _param_leaves(tree):
    from repro_torch.models.meta import leaves
    return list(leaves(tree))


def _run_on_card(code: str) -> str:
    """A snippet in its own process (a process group lives for the whole
    process); returns its output."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(repo, "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.mark.cuda
def test_nccl_one_card_mesh_trains_as_the_straight_trainer():
    """`Trainer(mesh=(1, 1))` on a real nccl group of world size 1: two steps'
    losses and grad norms within 1e-3 of the straight `Trainer`'s (the first
    loss equal), under deterministic algorithms."""
    import socket
    _need_card()
    with socket.socket() as s:            # a free port for the rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = _run_on_card(r'''
import os, torch, torch.distributed as dist
torch.use_deterministic_algorithms(True)
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT="@PORT@", RANK="0", WORLD_SIZE="1")
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.train import Trainer
cfg = smoke_config(get_config("qwen2-vl-2b"))
st = StepSettings(accum=2, remat="dots")
a = Trainer(cfg, steps=2, batch=4, seq=64, settings=st).run()
b = Trainer(cfg, steps=2, batch=4, seq=64, settings=st, mesh=(1, 1)).run()
assert dist.get_world_size() == 1 and dist.get_backend() == "nccl"
for x, y in zip(a, b):
    print("PAIR", x["loss"], y["loss"], x["grad_norm"], y["grad_norm"])
dist.destroy_process_group()
'''.replace("@PORT@", str(port)))
    pairs = [[float(v) for v in l.split()[1:]] for l in out.splitlines() if l.startswith("PAIR")]
    assert len(pairs) == 2 and pairs[0][0] == pairs[0][1]
    for la, lb, ga, gb in pairs:
        assert abs(la - lb) <= 1e-3 * abs(la) and abs(ga - gb) <= 1e-3 * abs(ga)


@pytest.mark.cuda
def test_fake_pg_capture_on_card():
    """The capture of a 2x4 smoke train step as rank 0 under the fake process
    group, with the tensors on the card: sites, grad_sync on data, attention,
    FLOPs and a peak allocation."""
    _need_card()
    out = _run_on_card(r'''
import torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import trace_step
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.optim import adamw
cfg = smoke_config(get_config("chatglm3-6b"))
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cuda")
params = sh.distribute_params(api.init_params(cfg, 0, dtype=torch.float32), mesh,
                              sh.param_placements(cfg, mesh))
oc = adamw.AdamWConfig()
opt = adamw.init(oc, params)
host = {k: v.cpu().numpy() for k, v in api.demo_batch(cfg, 8, 64).items()}
specs = sh.batch_pspecs(cfg, type("S", (), {"global_batch": 8, "seq_len": 64})(), mesh)
batch = shard_batch(host, mesh, {k: sh.placements_for(s, mesh) for k, s in specs.items()})
with activation_sharding(mesh):
    tr = trace_step(make_train_step(cfg, oc, StepSettings(accum=2, remat="full")),
                    (params, opt, batch), mesh, spec)
sems = {(e.semantic, e.link_class) for e in tr.events}
assert tr.sites > 0 and ("grad_sync", "nvlink.data") in sems, sems
assert any(s == "attention" for s, _ in sems)
assert tr.hlo_flops > 0 and tr.per_device_memory_bytes > 0
print("SITES", tr.sites)
''')
    assert "SITES" in out


@pytest.mark.cuda
def test_sort_dispatch_matches_einsum_on_card():
    """The MoE sort dispatch on a one-rank nccl mesh against the einsum
    dispatch without a mesh, on the card at the smoke size with the no-drop
    capacity (E/k): output and aux in fp32, every gradient within 1e-4, and
    no kernel launched."""
    import socket
    _need_card()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = _run_on_card(r'''
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.kernels import flash_attention as fa, mamba_scan as ms
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
cfg = smoke_config(get_config("qwen3-moe-235b-a22b")).replace(num_experts=8, top_k=2,
                                                             capacity_factor=4.0)
g = torch.Generator(device="cuda").manual_seed(0)
params = {k: torch.randn(m.shape, generator=g, device="cuda") * 0.1
          for k, m in moe.moe_meta(cfg).items()}
x = torch.randn(2, 64, cfg.d_model, generator=g, device="cuda")
launches = (fa.launches, ms.launches)

def run(dispatch, mesh):
    if mesh is None:
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        y, aux = moe.apply_moe(cfg.replace(moe_dispatch=dispatch), p, xx)
        ((y ** 2).mean() + 0.01 * aux).backward()
        return y.detach(), float(aux), {"x": xx.grad, **{k: t.grad for k, t in p.items()}}
    with activation_sharding(mesh):
        p = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()]).requires_grad_()
             for k, v in params.items()}
        xx = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()
        y, aux = moe.apply_moe(cfg.replace(moe_dispatch=dispatch), p, xx)
        ((y ** 2).mean() + 0.01 * aux).backward()
        grads = {k: t.grad.full_tensor() for k, t in [("x", xx)] + list(p.items())}
        return y.full_tensor().detach(), float(aux.full_tensor()), grads

mesh, _ = make_host_mesh((1, 1), ("data", "model"), backend="nccl",
                         init_method="tcp://localhost:@PORT@", rank=0)
ys, auxs, gs = run("sort", mesh)
ye, auxe, ge = run("einsum", None)
rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
print("Y", rel(ys, ye), "AUX", abs(auxs - auxe))
for k in gs:
    print("G", k, rel(gs[k], ge[k]), bool(torch.isfinite(gs[k]).all()), float(gs[k].abs().max()))
print("LAUNCHES", (fa.launches, ms.launches) == launches)
torch.distributed.destroy_process_group()
'''.replace("@PORT@", str(port)))
    lines = out.splitlines()
    y = next(l.split() for l in lines if l.startswith("Y"))
    assert float(y[1]) < 2e-5 and float(y[3]) < 1e-6
    grads = [l.split() for l in lines if l.startswith("G ")]
    assert len(grads) == 5
    for _, name, rel, finite, peak in grads:
        assert float(rel) < 1e-4 and finite == "True" and float(peak) > 0, name
    assert "LAUNCHES True" in out


@pytest.mark.cuda
def test_captured_trace_session_saves_and_loads_on_card(tmp_path):
    """A capture on the card (the sort dispatch's forward and backward as
    rank 0 of 2x4 under the fake process group) saved as a session in json,
    npz and uncompressed npz, and loaded back (the last with mmap): the same
    labels, totals and tables; the combine's sum over model is there."""
    _need_card()
    out = _run_on_card(r'''
import json, sys
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import trace_step
from repro_torch.core.session import TraceSession
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
cfg = smoke_config(get_config("qwen3-moe-235b-a22b")).replace(num_experts=8, top_k=2,
                                                             moe_dispatch="sort")
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cuda")
p = {k: distribute_tensor(torch.randn(m.shape, device="cuda"), mesh,
                          [Replicate(), Shard(0) if k != "router" else Replicate()],
                          src_data_rank=None).requires_grad_()
     for k, m in moe.moe_meta(cfg).items()}
x = distribute_tensor(torch.randn(4, 32, cfg.d_model, device="cuda"), mesh,
                      [Shard(0), Replicate()], src_data_rank=None)

def step(p, x):
    y, aux = moe.apply_moe(cfg, p, x)
    ((y.float() ** 2).mean() + 0.01 * aux).backward()

with activation_sharding(mesh):
    tr = trace_step(step, (p, x), mesh, spec, label="moe-sort")
sess = TraceSession("card", [tr])
want = (sess.labels(), sess.totals(), sess.table(), sess.table(by="semantic", metric="time"))
for path, kw in (("@DIR@/s.json", {}), ("@DIR@/s.npz", {}), ("@DIR@/u.npz", {"mmap": True})):
    sess.save(path, compress=not kw)
    got = TraceSession.load(path, **kw)
    assert (got.labels(), got.totals(), got.table(),
            got.table(by="semantic", metric="time")) == want, path
print("KEYS", json.dumps(sorted({(e.semantic, e.kind, e.link_class) for e in tr.events})))
'''.replace("@DIR@", str(tmp_path)))
    keys = {tuple(k) for k in json.loads(next(l for l in out.splitlines()
                                              if l.startswith("KEYS"))[5:])}
    assert ("moe_combine", "all-reduce", "nvlink.model") in keys
    assert not any(k[1] == "all-to-all" for k in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,return_state", [("bfloat16", 64, True), ("float32", 128, False)])
def test_register_fake_shapes_match_the_kernels_outputs(dtype, D, return_state):
    """Each custom op's fake implementation gives its CUDA output's shape, dtype
    and strides (K1: [B, Sq, H, D] seen as [B, H, Sq, D]; K2: y, and h_S when
    asked), and runs under FakeTensorMode with no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _need_card()
    (q, _), (k, _), (v, _) = qkv(D, 2, 4, 2, 96, 96, D, dtype)
    a, bx, c = (torch.from_numpy(t).cuda() for t in scan_inputs(3, 2, 64, 32, 8))
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    real = [fa.flash_attention(q, k, v, window=16), *ms.mamba_scan(a, bx, c, return_state=True)]
    counts = (fa.launches, ms.launches)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fk, fv, fa_, fbx, fc = (mode.from_tensor(t) for t in (q, k, v, a, bx, c))
        fake = [fa.flash_attention(fq, fk, fv, window=16),
                *ms.mamba_scan(fa_, fbx, fc, return_state=True)]
        y_only = ms.mamba_scan(fa_, fbx, fc, return_state=return_state)
    assert (fa.launches, ms.launches) == counts
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride(), f.device) == (r.shape, r.dtype, r.stride(), r.device)
    got = y_only[0] if return_state else y_only
    assert got.shape == real[1].shape


def test_eager_launch_takes_only_plain_cuda_tensors():
    """`build.eager`: a CPU tensor, a fake tensor and any tensor under a
    dispatch mode go through the custom ops (or the plain versions), never
    past them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import build
    t = torch.zeros(2)
    assert not build.eager(t)
    with FakeTensorMode() as mode:
        assert not build.eager(mode.from_tensor(t))
    with FlopCounterMode(display=False):
        assert not build.eager(t)


@pytest.mark.cuda
def test_eager_launch_equals_the_custom_op_on_card():
    """K1 and the fused K2 launched past their custom ops give the ops' bits
    and count their launches; under a dispatch mode (the flop counter) they
    go through the ops, which the mode sees."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import build
    _need_card()
    (q, _), (k, _), (v, _) = qkv(64, 2, 5, 1, 200, 200, 64, "bfloat16")
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    delta, x, a, b, c = _fused_inputs(5, 2, 300, 64, 16, "bfloat16")
    assert build.eager(q)
    counts = (fa.launches, ms.launches)
    got = fa.flash_attention(q, k, v, window=48)
    got_y, got_h = ms.mamba_scan_fused(delta, x, a, b, c, return_state=True)
    assert (fa.launches, ms.launches) == (counts[0] + 1, counts[1] + 1)
    want = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 48, 0, 64 ** -0.5)
    want_y, want_h = torch.ops.repro_torch.mamba_scan_fused(delta, x, a, b, c, True)
    assert torch.equal(got, want) and got.stride() == want.stride()
    assert torch.equal(got_y, want_y) and torch.equal(got_h, want_h)
    with FlopCounterMode(display=False) as flops:
        fa.flash_attention(q, k, v)
    assert flops.get_total_flops() == 4 * 2 * 5 * 200 * 200 * 64


@pytest.mark.cuda
def test_kernels_under_local_map_on_a_one_rank_nccl_mesh():
    """K1 (through `attend`, flash) and K2 (through `ssm._scan_local`, and its
    fused entry point through `ssm._params_local`) on the DTensors of a one-rank
    nccl mesh give the straight calls' outputs bit for bit, one launch each."""
    import socket
    _need_card()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = _run_on_card(r'''
import os, torch, torch.distributed as dist
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT="@PORT@", RANK="0", WORLD_SIZE="1")
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.kernels import flash_attention as fa, mamba_scan as ms, ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, ssm
cfg = smoke_config(get_config("hymba-1.5b"))
mesh, _ = make_host_mesh((1, 1), ("data", "model"), backend="nccl")
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn(2, 64, 4, 16, generator=g, device="cuda").bfloat16()
k = torch.randn(2, 64, 2, 16, generator=g, device="cuda").bfloat16()
v = torch.randn(2, 64, 2, 16, generator=g, device="cuda").bfloat16()
a = torch.rand(2, 64, 32, 4, generator=g, device="cuda")
bx = torch.randn(2, 64, 32, 4, generator=g, device="cuda")
c = torch.randn(2, 64, 4, generator=g, device="cuda")
want_o = attention.attend(cfg, q, k, v, impl="flash", window=16)
want_y, want_h = ops.mamba_scan(a, bx, c, return_state=True)
delta = torch.rand(2, 64, 32, generator=g, device="cuda")
x = torch.randn(2, 64, 32, generator=g, device="cuda").bfloat16()
A = -torch.rand(32, 4, generator=g, device="cuda")
B_, C_ = (torch.randn(2, 64, 4, generator=g, device="cuda") for _ in range(2))
want_fy, want_fh = ops.mamba_scan_fused(delta, x, A, B_, C_, return_state=True)
d = lambda t: distribute_tensor(t, mesh, [Shard(0), Replicate()])
r = lambda t: distribute_tensor(t, mesh, [Replicate(), Replicate()])
before = (fa.launches, ms.launches)
with torch.no_grad(), activation_sharding(mesh):
    o = attention.attend(cfg, d(q), d(k), d(v), impl="flash", window=16)
    y, h = ssm._scan_local(ops.mamba_scan, d(a), d(bx), d(c), True)
    fy, fh = ssm._params_local(ops.mamba_scan_fused, d(delta), d(x), r(A), d(B_), d(C_), True)
assert (fa.launches - before[0], ms.launches - before[1]) == (1, 2)
assert dist.get_backend() == "nccl"
for got, want in ((o, want_o), (y, want_y), (h, want_h), (fy, want_fy), (fh, want_fh)):
    assert torch.equal(got.full_tensor(), want), (got.full_tensor() - want).abs().max()
print("LOCAL_MAP_OK")
dist.destroy_process_group()
'''.replace("@PORT@", str(port)))
    assert "LOCAL_MAP_OK" in out
