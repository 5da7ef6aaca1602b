"""Port flash attention vs the reference Pallas kernel (interpret mode) and its oracle.

On the CPU the port's wrapper runs the kernel's plain version
(`repro_torch.kernels.ref`); the CUDA kernel itself is checked against the
same plain version in `test_torch_cuda.py`, which skips without a card.
Tolerances are the reference's own (`tests/test_kernels.py`): fp32 2e-5,
bf16 3e-2, max abs error.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import FLASH_CASES, max_abs_err as _err, qkv as _qkv, randn, to_np
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as fa_kernel
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro.configs import ARCHS
from repro.configs import smoke_config as jax_smoke
from repro.models.attention import attend_blocked as jax_attend_blocked
from repro_torch.models.attention import attend, attend_blocked, attend_naive

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("B,H,K,S,D,causal,window,dtype,tol", FLASH_CASES)
def test_flash_matches_pallas_kernel(B, H, K, S, D, causal, window, dtype, tol):
    (q, qn), (k, kn), (v, vn) = _qkv(S + D, B, H, K, S, S, D, dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(x, JNP[dtype]) for x in (qn, kn, vn))
    pallas = fa_kernel(jq, jk, jv, causal=causal, window=window, interpret=True,
                       bq=128, bk=128)
    oracle = jax_ref(jq, jk, jv, causal=causal, window=window)
    assert out.shape == (B, H, S, D) and out.dtype == q.dtype
    assert _err(to_np(out), pallas) < tol
    assert _err(to_np(out), oracle) < tol


def test_flash_q_offset_matches_pallas_kernel():
    """q_offset shifts the causal diagonal (decode against a prefix cache)."""
    (q, qn), (k, kn), (v, vn) = _qkv(1, 1, 2, 2, 128, 256, 128, "float32")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=128)
    pallas = fa_kernel(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=True,
                       q_offset=128, interpret=True)
    assert _err(to_np(out), pallas) < 2e-5


def test_flash_ops_wrapper_head_dim_120():
    """h2o-danube head_dim 120: the reference pads to 128, the port reads it as is."""
    rng = np.random.default_rng(2)
    B, S, H, K, Dh = 1, 128, 4, 2, 120
    (q, qn), (k, kn), (v, vn) = (randn(rng, (B, S, n, Dh), "float32") for n in (H, K, K))
    out = ops.flash_attention(None, q, k, v, causal=True)
    ref = jops.flash_attention(None, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                               causal=True, interpret=True)
    assert out.shape == (B, S, H, Dh)
    assert _err(to_np(out), ref) < 2e-5


def test_attend_flash_matches_naive_in_model_layout():
    cfg = smoke_config(get_config("chatglm3-6b")).replace(compute_dtype="float32")
    rng = np.random.default_rng(3)
    q, k, v = (randn(rng, (2, 32, n, 16), "float32")[0] for n in (4, 2, 2))
    for window in (0, 8):
        a = attend(cfg, q, k, v, causal=True, window=window, impl="flash")
        b = attend_naive(cfg, q, k, v, causal=True, window=window)
        assert _err(to_np(a), to_np(b)) < 2e-5
    with pytest.raises(ValueError, match="attn impl"):
        attend(cfg, q, k, v, impl="pallas")


@pytest.mark.parametrize("window", [0, 32])
def test_blocked_attention_matches_naive_and_reference(window):
    """The plain online-softmax path (the reference's test_model_blocked_vs_naive_attention)."""
    cfg = smoke_config(get_config("chatglm3-6b"))
    rng = np.random.default_rng(6)
    (q, qn), (k, kn), (v, vn) = (randn(rng, (2, 128, n, 16), "float32") for n in (4, 2, 2))
    out = attend_blocked(cfg, q, k, v, causal=True, window=window, kv_chunk=32)
    assert _err(to_np(out), to_np(attend_naive(cfg, q, k, v, causal=True, window=window))) < 1e-5
    ref = jax_attend_blocked(jax_smoke(ARCHS["chatglm3-6b"]), jnp.asarray(qn), jnp.asarray(kn),
                             jnp.asarray(vn), causal=True, window=window, kv_chunk=32)
    assert _err(to_np(out), ref) < 2e-5


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    (q, _), (k, _), (v, _) = _qkv(4, 1, 2, 1, 64, 64, 32, "float32")
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True, window=16))
    assert fa.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (q, _), (k, _), (v, _) = _qkv(5, 1, 2, 1, 64, 64, 32, "float32")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 8, 320)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))



def test_kernel_builds_into_the_checkout_and_nowhere_else(tmp_path, monkeypatch):
    root = Path(__file__).resolve().parents[1]
    assert build.build_dir(fa.SOURCE) == root / "build" / "repro_torch"
    assert build.library_path(fa.SOURCE).parent == build.build_dir(fa.SOURCE)
    installed = tmp_path / "site-packages" / "repro_torch"    # no src/, no pyproject.toml
    monkeypatch.setattr(build, "PACKAGE", installed)
    with pytest.raises(RuntimeError, match="only from a checkout"):
        build.library_path(installed / "csrc" / "flash_attention.cu")


# ---- the tensor-core kernel's dispatch rule and arithmetic ------------------------------

@pytest.mark.parametrize("dtype,head_dim,kernel", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 120, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 129, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 64, "tensor_core_fp32"), (torch.float32, 128, "tensor_core_fp32"),
    (torch.float32, 256, "tensor_core_fp32"),
])
def test_dispatch_rule(dtype, head_dim, kernel):
    """bf16 runs on the tensor cores by wgmma at every head dim up to 256; fp32 (2e-5,
    which one TF32 product cannot meet) on the tensor cores in 3xTF32."""
    assert fa.kernel_for(dtype, head_dim) == kernel


def test_tma_preconditions_name_the_reason():
    """TMA needs a 16-byte aligned base and strides of 16-byte multiples in every dim
    longer than 1; a model-layout view of a contiguous [B, S, H, D] tensor has them."""
    base = torch.zeros(2, 64, 4, 128, dtype=torch.bfloat16)
    assert fa.tma_problem("q", base.transpose(1, 2)) is None
    assert fa.tma_problem("q", torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)) is None
    shifted = base.view(-1)[1:1 + 2 * 64 * 4 * 120].view(2, 64, 4, 120).transpose(1, 2)
    assert "16-byte aligned" in fa.tma_problem("k", shifted)
    narrow = torch.zeros(2, 64, 4, 124, dtype=torch.bfloat16)[..., :120].transpose(1, 2)
    assert "stride of 124 elements in dim 1" in fa.tma_problem("v", narrow)
    one_head = torch.zeros(2, 64, 1, 124, dtype=torch.bfloat16)[..., :120].transpose(1, 2)
    assert "in dim 2" in fa.tma_problem("v", one_head)   # S's stride, 124 elements


LOG2E = 1.4426950408889634


def emulate_tensor_core_kernel(q, k, v, *, causal, window, q_offset, split_p=True,
                               bm=128, bn=128):
    """The arithmetic of `flash_fwd_wgmma_kernel`, in PyTorch on the CPU.

    q [B,H,Sq,D], k/v [B,K,Skv,D] bf16.  Per 128-row q tile, the KV tiles of `bn` keys
    that the kernel visits (128 at D <= 128, 64 at D = 256); scores in fp32 from the bf16 inputs, scaled to base 2;
    running max and sum in fp32, the sum taken from the fp32 P; P split into bf16
    P_hi (rounded to nearest) + P_lo (the rest, truncated), or with split_p=False
    rounded once to bf16, before the fp32 P V; O / max(l, 1e-30) rounded once to bf16.
    """
    B, H, Sq, D = q.shape
    K, Skv = k.shape[1], k.shape[2]
    c = torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    kf = k.float().repeat_interleave(H // K, dim=1)
    vf = v.float().repeat_interleave(H // K, dim=1)
    out = torch.empty(B, H, Sq, D)
    nk = -(-Skv // bn)
    for q0 in range(0, Sq, bm):
        rows = slice(q0, min(q0 + bm, Sq))
        qa0 = q0 + q_offset
        qi = torch.arange(rows.start, rows.stop)[:, None] + q_offset
        kt_end = min(nk, (qa0 + bm - 1) // bn + 1) if causal else nk
        kt_begin = max(0, qa0 - window + 1) // bn if window > 0 else 0
        n = rows.stop - rows.start
        m = torch.full((B, H, n, 1), -1e30)
        l = torch.zeros(B, H, n, 1)
        o = torch.zeros(B, H, n, D)
        for kt in range(kt_begin, kt_end):
            keys = slice(kt * bn, min(kt * bn + bn, Skv))
            s = (q[:, :, rows].float() @ kf[:, :, keys].transpose(-1, -2)) * c
            ki = torch.arange(keys.start, keys.stop)[None, :]
            ok = torch.ones(n, keys.stop - keys.start, dtype=torch.bool)
            if causal:
                ok &= ki <= qi
            if window > 0:
                ok &= (qi - ki) < window
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            m = m_new
            l = l * alpha + p.sum(-1, keepdim=True)
            if split_p:
                hi = ((p.view(torch.int32) + 0x8000) & -0x10000).view(torch.float32)
                lo = ((p - hi).view(torch.int32) & -0x10000).view(torch.float32)
                pv = hi @ vf[:, :, keys] + lo @ vf[:, :, keys]
            else:
                pv = p.bfloat16().float() @ vf[:, :, keys]
            o = o * alpha + pv
        out[:, :, rows] = o / l.clamp_min(1e-30)
    return out.bfloat16()


def _bf16_steps(out, ref):
    """Largest |out - ref| in bf16 rounding steps of ref (2^-7 |ref| + 1e-5)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(out - ref) / (2.0 ** -7 * np.abs(ref) + 1e-5)).max())


# reduced path shapes and the kernel's keys per KV tile: chatglm3-6b's D=128 with 16:1
# GQA, hymba-1.5b's D=64 with 5:1 GQA and a window, h2o-danube's D=120 with a
# q_offset (the Pallas kernel takes D % 128 == 0, so D is zero-padded for it, as the
# reference's wrapper pads it), and gemma3-4b's D=256 with 2:1 GQA at BN 64, causal
# and with a window and a q_offset
EMULATED_CASES = [
    (1, 16, 1, 384, 128, True, 0, 0, 128),
    (1, 5, 1, 384, 64, True, 160, 0, 128),
    (1, 4, 2, 256, 120, True, 0, 128, 128),
    (1, 4, 2, 384, 256, True, 0, 0, 64),
    (1, 4, 2, 384, 256, True, 160, 128, 64),
]


@pytest.mark.parametrize("B,H,K,S,D,causal,window,q_offset,bn", EMULATED_CASES)
def test_tensor_core_arithmetic_meets_the_path_limits(B, H, K, S, D, causal, window, q_offset,
                                                      bn):
    """The kernel's arithmetic (P split into bf16 hi + lo) against the reference's Pallas
    kernel in interpret mode: max abs error < 1e-2 and every element within two bf16
    steps, the limits chip_smoke.py holds the kernel to.  A single bf16 P is printed
    beside it; it must not be the better of the two."""
    (q, qn), (k, kn), (v, vn) = _qkv(S + D + window, B, H, K, S, S, D, "bfloat16")
    q, qn = q[:, :, q_offset:], qn[:, :, q_offset:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    pad = [(0, 0)] * 3 + [(0, (-D) % 128)]
    jq, jk, jv = (jnp.asarray(np.pad(x, pad), jnp.bfloat16) for x in (qn, kn, vn))
    pallas = np.asarray(fa_kernel(jq, jk, jv, interpret=True, bq=128, bk=128, scale=D ** -0.5,
                                  **kw), np.float32)[..., :D]
    split = to_np(emulate_tensor_core_kernel(q, k, v, bn=bn, **kw))
    single = to_np(emulate_tensor_core_kernel(q, k, v, split_p=False, bn=bn, **kw))
    errs = {name: (_err(x, pallas), _bf16_steps(x, pallas))
            for name, x in (("split", split), ("single", single))}
    print(f"tensor-core arithmetic vs Pallas (max abs, bf16 steps): {errs}")
    assert errs["split"][0] < 1e-2 and errs["split"][1] <= 2.0
    assert errs["split"][1] <= errs["single"][1]
    assert _err(split, to_np(flash_attention_ref(q, k, v, **kw))) < 1e-2
