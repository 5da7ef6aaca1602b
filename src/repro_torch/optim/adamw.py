"""AdamW with global-norm clipping and a configurable moment dtype, written
out as the reference's `repro.optim.adamw` is (not `torch.optim.AdamW`).

Params, grads and moments are dict/list trees of one structure.  The update
runs in fp32 and casts back to each tensor's dtype; weight decay applies to
every leaf, as in the reference; the learning rate is the schedule's at the
incremented count.  The reference returns new trees and donates the old
buffers; here the update writes params and moments in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.meta import leaves, tree_map
from repro_torch.scope import scope


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # bfloat16 halves the moments' memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to `min_lr_ratio` of the peak; fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """Zero moments in `state_dtype` (with a DTensor param's placements) and an int32
    step count, on the params' device."""
    dt = getattr(torch, cfg.state_dtype)
    device = next(leaves(params)).device
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step, written into `params` and `state` in place. Returns
    (params, state, {"grad_norm", "lr"})."""
    with scope("optimizer"):
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                 if cfg.clip_norm else 1.0)
        lr = schedule(cfg, count)
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * torch.square(g)
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            p32 = p.float()
            p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
            m.copy_(m32)
            v.copy_(v32)
        state["count"] = count
        return params, state, {"grad_norm": gnorm, "lr": lr}
