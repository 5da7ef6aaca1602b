"""Model-layout wrappers around the kernels.

`flash_attention`: the reference wrapper (`repro/kernels/ops.py`) transposes
[B, S, H, Dh] to [B, H, S, Dh] and pads Dh to a multiple of 128 for the TPU's
lanes.  The CUDA kernels read strides and take any Dh up to 256 (the
tensor-core one pads Dh in shared memory, by TMA's zero fill), so here the
transpose is a view and nothing is padded in device memory.

`mamba_scan`: the reference wrapper casts a_bar, bx and c to fp32 and passes
the TPU's tiling knobs (`chunk`, `di_block`); the CUDA kernel has none, so
this one only casts.  `mamba_scan_fused` takes the mixer's raw dt projection
and the scan's other inputs before discretisation (x, A, B, C), and the
gate's (dt_bias, D, z); it casts dt and z to x's dtype (fp32, or bf16: the
kernel widens them) and the rest to fp32.  The model's prefill
(`models.ssm.apply_ssm`) calls it, so the [B, S, Di, N] a_bar and bx are
never made.
`mamba_scan_train` casts as it does and is differentiable: the model's
training scan on the card.

Each kernel module keeps its own counters, incremented where its kernels
launch; `launch_counts` reads them all.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms


def launch_counts() -> dict[str, int]:
    """The kernel modules' counters, flat, under one naming rule:
    `<module>.<counter>` for a module's int counters and `<module>/<key>` for
    each key of its `kernel_launches` (its launches by kernel or entry
    point), module `flash_attention` or `mamba_scan`.  The int counters are
    `launches` (all of the module's), K1's `window_launches` (those with a
    window) and K2's `chunks` (chunks of time over its fused launches).  A
    step record keeps the change of each."""
    out = {"flash_attention.launches": fa.launches,
           "flash_attention.window_launches": fa.window_launches,
           "mamba_scan.launches": ms.launches, "mamba_scan.chunks": ms.chunks}
    for name, mod in (("flash_attention", fa), ("mamba_scan", ms)):
        out.update((f"{name}/{key}", n) for key, n in mod.kernel_launches.items())
    return out


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


def mamba_scan_fused(dt, x, a, b, c, delta_bias, d_skip, z, *, return_state=False):
    """dt/x/z [B,S,Di], a [Di,N], b/c [B,S,N], delta_bias/d_skip [Di] -> y [B,S,Di]
    in x's dtype (and h_S [B,Di,N] fp32)."""
    f32 = torch.float32
    x = x if x.dtype in (f32, torch.bfloat16) else x.to(f32)
    return ms.mamba_scan_fused(dt.to(x.dtype), x, a.to(f32), b.to(f32), c.to(f32),
                               delta_bias.to(f32), d_skip.to(f32), z.to(x.dtype),
                               return_state=return_state)


def mamba_scan_train(delta, x, a, b, c, *, return_state=False):
    """`mamba_scan_fused`'s arguments and results, differentiable."""
    f32 = torch.float32
    x = x if x.dtype in (f32, torch.bfloat16) else x.to(f32)
    return ms.mamba_scan_train(delta.to(f32), x, a.to(f32), b.to(f32), c.to(f32),
                               return_state=return_state)
