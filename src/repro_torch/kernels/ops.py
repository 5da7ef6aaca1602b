"""Model-layout wrapper around the flash attention kernel.

The reference wrapper (`repro/kernels/ops.py`) transposes [B, S, H, Dh] to
[B, H, S, Dh] and pads Dh to a multiple of 128 for the TPU's lanes.  The CUDA
kernel reads strides and takes any Dh up to 256, so here the transpose is a
view and nothing is padded.  The launch counter is `flash_attention.launches`,
incremented where the kernel launches.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa


def flash_attention(cfg, q, k, v, *, causal=True, window=0, q_offset=0):
    """q [B,S,H,Dh], k/v [B,S,K,Dh] -> [B,S,H,Dh]; scale is cfg.head_dim**-0.5."""
    scale = cfg.head_dim ** -0.5 if cfg is not None else q.shape[-1] ** -0.5
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, window=window, q_offset=q_offset,
                             scale=scale)
    return out.transpose(1, 2)
