"""Model-layout wrappers around the kernels.

`flash_attention`: the reference wrapper (`repro/kernels/ops.py`) transposes
[B, S, H, Dh] to [B, H, S, Dh] and pads Dh to a multiple of 128 for the TPU's
lanes.  The CUDA kernels read strides and take any Dh up to 256 (the
tensor-core one pads Dh in shared memory, by TMA's zero fill), so here the
transpose is a view and nothing is padded in device memory.

`mamba_scan`: the reference wrapper casts a_bar, bx and c to fp32 and passes
the TPU's tiling knobs (`chunk`, `di_block`); the CUDA kernel has none, so
this one only casts.  `mamba_scan_fused` takes the scan's inputs before
discretisation (delta, x, A, B, C) and casts them but x to fp32 (x may stay
bf16: the kernel widens it); the model's prefill (`models.ssm.apply_ssm`)
calls it, so the [B, S, Di, N] a_bar and bx are never made.
`mamba_scan_train` casts as it does and is differentiable: the model's
training scan on the card.

Each launch counter (`flash_attention.launches`, `mamba_scan.launches`) is
incremented where its kernel launches; `flash_attention.kernel_launches`
splits K1's by the kernel that ran, `flash_attention.window_launches` counts
K1's launches with a window, `mamba_scan.kernel_launches` K2's by the entry
point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms


def flash_attention(cfg, q, k, v, *, causal=True, window=0, q_offset=0):
    """q [B,S,H,Dh], k/v [B,S,K,Dh] -> [B,S,H,Dh]; scale is cfg.head_dim**-0.5."""
    scale = cfg.head_dim ** -0.5 if cfg is not None else q.shape[-1] ** -0.5
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, window=window, q_offset=q_offset,
                             scale=scale)
    return out.transpose(1, 2)


def mamba_scan(a_bar, bx, c, *, return_state=False):
    """a_bar/bx [B,S,Di,N], c [B,S,N] -> y [B,S,Di] fp32 (and h_S [B,Di,N] fp32)."""
    f32 = torch.float32
    return ms.mamba_scan(a_bar.to(f32), bx.to(f32), c.to(f32), return_state=return_state)


def mamba_scan_fused(delta, x, a, b, c, *, return_state=False):
    """delta/x [B,S,Di], a [Di,N], b/c [B,S,N] -> y [B,S,Di] fp32 (and h_S [B,Di,N] fp32)."""
    f32 = torch.float32
    x = x if x.dtype in (f32, torch.bfloat16) else x.to(f32)
    return ms.mamba_scan_fused(delta.to(f32), x, a.to(f32), b.to(f32), c.to(f32),
                               return_state=return_state)


def mamba_scan_train(delta, x, a, b, c, *, return_state=False):
    """`mamba_scan_fused`'s arguments and results, differentiable."""
    f32 = torch.float32
    x = x if x.dtype in (f32, torch.bfloat16) else x.to(f32)
    return ms.mamba_scan_train(delta.to(f32), x, a.to(f32), b.to(f32), c.to(f32),
                               return_state=return_state)
