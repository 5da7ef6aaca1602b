"""Shared model layers: rms/layer norms, RoPE (standard/partial/m-rope), GLU and
plain MLPs, embeddings with learned positions, separate or tied heads.

Conventions (as in the reference `repro.models.layers`):
  * the residual stream is `compute_dtype`; norm statistics and softmax in fp32.
  * learned matrices are `ParamMeta` with logical axes, kept `[in, out]` so
    every projection is `x @ w`.
  * the reference's sharding constraints are `distributed.autoshard` calls at
    the same sites (no-ops without a mesh); its `jax.named_scope`s become
    `repro_torch.scope` ranges of the same names, which the capture reads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.autoshard import constrain_logits, constrain_residual
from repro_torch.models.meta import ParamMeta
from repro_torch.scope import scope


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def norm_meta(cfg, dim: Optional[int] = None):
    d = dim or cfg.d_model
    m = {"scale": ParamMeta((d,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        m["bias"] = ParamMeta((d,), (None,), init="zeros")
    return m


def apply_norm(cfg, p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm with the reference's numerics: squares in the
    working dtype, means accumulated in fp32 (LayerNorm: var = E[x^2] - mu^2
    in fp32), mu and the rsqrt cast back to the working dtype before the
    (working-dtype) products."""
    dtype = x.dtype
    ms = torch.square(x).mean(dim=-1, keepdim=True, dtype=torch.float32)
    if cfg.norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(ms - torch.square(mu) + eps)
        y = (x - mu.to(dtype)) * inv.to(dtype)
        return y * p["scale"].to(dtype) + p["bias"].to(dtype)
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
# MLP (gated: SwiGLU, GeGLU; plain with glu=False)
# --------------------------------------------------------------------------

def mlp_meta(cfg):
    d, f = cfg.d_model, cfg.d_ff
    m = {"w_up": ParamMeta((d, f), ("embed", "mlp")),
         "w_down": ParamMeta((f, d), ("mlp", "embed"))}
    if cfg.glu:
        m = {"w_gate": ParamMeta((d, f), ("embed", "mlp")), **m}
    return m


def act(cfg, x: torch.Tensor) -> torch.Tensor:
    """silu, or gelu as the reference's `jax.nn.gelu` computes it by default:
    the tanh approximation (torch's default is the exact erf form)."""
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    with scope("mlp"):
        dt = x.dtype
        if cfg.glu:
            h = act(cfg, x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        else:
            h = act(cfg, x @ p["w_up"].to(dt))
        # on a mesh: the row-parallel product's partial sum is reduced here
        # (an all-reduce over `model`, as GSPMD chooses); DTensor alone would
        # reduce-scatter it into the residual and gather it back later
        return constrain_residual(h @ p["w_down"].to(dt))


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------

def embed_meta(cfg):
    # a tied table doubles as the LM head: scaled down so initial logits are O(1)
    scale = cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0
    m = {"in_table": ParamMeta((cfg.vocab_size, cfg.d_model),
                               ("in_vocab", "embed_tp"), scale=scale)}
    if not cfg.tie_embeddings:
        m["out_head"] = ParamMeta((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.rope == "learned":
        m["pos_table"] = ParamMeta((cfg.source_len + cfg.max_positions, cfg.d_model),
                                   (None, "embed_tp"), scale=0.02)
    return m


def embed_tokens(cfg, p, tokens: torch.Tensor, positions=None) -> torch.Tensor:
    """Gather path: rows of the table, cast to the compute dtype; with learned
    positions and `positions` given, plus those rows of the position table."""
    with scope("embed"):
        cdt = getattr(torch, cfg.compute_dtype)
        # the embedding op, not indexing: on a mesh DTensor leaves the table's
        # gradient partial over the batch's axes, synchronised with every other
        # gradient (indexing's strategy gathers the output gradient over `data`)
        x = F.embedding(tokens, p["in_table"]).to(cdt)
        if cfg.rope == "learned" and positions is not None:
            x = x + F.embedding(positions, p["pos_table"]).to(cdt)
        return constrain_residual(x)


def head_table(cfg, p) -> torch.Tensor:
    """The LM head's [D, V] matrix: the tied table's transpose, or out_head."""
    return p["in_table"].T if cfg.tie_embeddings else p["out_head"]


def logits_head(cfg, p, x: torch.Tensor) -> torch.Tensor:
    with scope("logits"):
        return constrain_logits(x @ head_table(cfg, p).to(x.dtype))
