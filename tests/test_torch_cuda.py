"""The CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Each test skips where torch.cuda.is_available() is false.
"""
import pytest
import torch

from _torch_parity import FLASH_CASES, max_abs_err, qkv, to_np
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import api
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
