"""Shared model layers: rmsnorm, RoPE (standard/partial/m-rope), GLU MLPs, embeddings.

Conventions (as in the reference `repro.models.layers`):
  * the residual stream is `compute_dtype`; norm statistics and softmax in fp32.
  * learned matrices are `ParamMeta` with logical axes, kept `[in, out]` so
    every projection is `x @ w`.
  * the reference's sharding constraints are no-ops on one card and are not
    copied; its `jax.named_scope`s become `record_function` ranges of the same
    names, for the profiler slice to attribute.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.meta import ParamMeta


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def norm_meta(cfg, dim: Optional[int] = None):
    return {"scale": ParamMeta((dim or cfg.d_model,), (None,), init="ones")}


def apply_norm(cfg, p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's numerics: squares in the working dtype,
    their mean accumulated in fp32, the rsqrt cast back to the working dtype
    before the (working-dtype) products."""
    dtype = x.dtype
    ms = torch.square(x).mean(dim=-1, keepdim=True, dtype=torch.float32)
    return x * torch.rsqrt(ms + eps).to(dtype) * p["scale"].to(dtype)


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head q/k RMSNorm (qwen3), all in fp32 as in the reference."""
    xf = x.float()
    ms = torch.square(xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (standard / partial / m-rope)
# --------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, n_freq: int, theta: float) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, n_freq] (fp32)."""
    freq = torch.arange(n_freq, dtype=torch.float32, device=positions.device)
    inv = theta ** (-freq / n_freq)
    return positions.to(torch.float32)[..., None] * inv


def _rotate_half(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mrope_angles(cfg, positions: torch.Tensor, dh: int) -> torch.Tensor:
    """M-RoPE: `mrope_sections` (t, h, w) split the head_dim/2 frequencies, and
    section i takes its angles from positions[i].  positions [3, B, S] ->
    angles [B, S, head_dim/2] (fp32)."""
    sections = cfg.mrope_sections
    if sum(sections) != dh // 2:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {dh // 2}")
    parts, start = [], 0
    for axis, sec in enumerate(sections):
        freq = torch.arange(start, start + sec, dtype=torch.float32, device=positions.device)
        inv = cfg.rope_theta ** (-2.0 * freq / dh)
        parts.append(positions[axis].to(torch.float32)[..., None] * inv)
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate the first `rope_fraction` of head_dim (all of it for m-rope),
    half-split (not interleaved).

    x [B, S, H, Dh]; positions [B, S] int, or [3, B, S] for m-rope.  cos/sin
    are cast to x's dtype before the products, as in the reference.  "none"
    and "learned" (positions are embedded, not rotated) return x unchanged.
    """
    if cfg.rope in ("none", "learned"):
        return x
    dh = x.shape[-1]
    if cfg.rope == "mrope":
        angles = _mrope_angles(cfg, positions, dh)
        rot = dh
    else:
        rot = int(dh * cfg.rope_fraction)
        rot -= rot % 2
        angles = _rope_angles(positions, rot // 2, cfg.rope_theta)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)   # [B,S,1,n_freq]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    if rot == dh:
        return _rotate_half(x, cos, sin)
    return torch.cat([_rotate_half(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


# --------------------------------------------------------------------------
# MLP (gated: SwiGLU, GeGLU)
# --------------------------------------------------------------------------

def mlp_meta(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamMeta((d, f), ("embed", "mlp")),
        "w_up": ParamMeta((d, f), ("embed", "mlp")),
        "w_down": ParamMeta((f, d), ("mlp", "embed")),
    }


def act(cfg, x: torch.Tensor) -> torch.Tensor:
    """silu, or gelu as the reference's `jax.nn.gelu` computes it by default:
    the tanh approximation (torch's default is the exact erf form)."""
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    with record_function("mlp"):
        dt = x.dtype
        h = act(cfg, x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------

def embed_meta(cfg):
    return {"in_table": ParamMeta((cfg.vocab_size, cfg.d_model),
                                  ("in_vocab", "embed_tp"), scale=1.0),
            "out_head": ParamMeta((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}


def embed_tokens(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    """Gather path: rows of the table, cast to the compute dtype."""
    with record_function("embed"):
        cdt = getattr(torch, cfg.compute_dtype)
        return p["in_table"][tokens].to(cdt)


def logits_head(cfg, p, x: torch.Tensor) -> torch.Tensor:
    with record_function("logits"):
        return x @ p["out_head"].to(x.dtype)
