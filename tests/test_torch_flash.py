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
