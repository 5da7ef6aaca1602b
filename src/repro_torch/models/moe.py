"""Mixture-of-Experts FFN with top-k routing: the reference's GShard/Switch
einsum dispatch (`repro.models.moe`).

Tokens are cut into groups; in each group a one-hot dispatch table sends
every kept (token, choice) to a slot of its expert, each expert runs its
SwiGLU on its `capacity` slots, and a combine table weighted by the
renormalised gates brings the results back.  Overflow past an expert's
capacity is dropped, in the GShard priority order: choice rank first, then
token order.  The reference's sort dispatch (`distributed/moe_ep.py`) runs
only under a device mesh, and without one falls through to this path.  The
port has not ported it yet: under a mesh `cfg.moe_dispatch="sort"` raises
(ROADMAP queue 1), and the einsum dispatch runs with the expert dim
constrained onto `model`, as the reference's does without "sort".
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.autoshard import constrain, current_mesh
from repro_torch.models.meta import ParamMeta
from repro_torch.scope import scope


def moe_meta(cfg):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        # the reference reads the router in fp32: a bf16 copy would change the routing
        "router": ParamMeta((d, e), ("embed", None), scale=0.02, dtype="float32"),
        "w_gate": ParamMeta((e, d, f), ("expert", "embed", "moe_mlp")),
        "w_up": ParamMeta((e, d, f), ("expert", "embed", "moe_mlp")),
        "w_down": ParamMeta((e, f, d), ("expert", "moe_mlp", "embed")),
    }


def capacity(cfg, group_tokens: int) -> int:
    c = math.ceil(cfg.top_k * group_tokens * cfg.capacity_factor / cfg.num_experts)
    return max(1, c)


def _group(x: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, int]:
    """[B,S,D] -> [G, Sg, D], Sg the largest of group_size, /2, /4, ... dividing S."""
    B, S, D = x.shape
    sg = min(group_size, S)
    while S % sg:
        sg //= 2
    return x.reshape(B * (S // sg), sg, D), sg


def router_dispatch(cfg, probs: torch.Tensor, cap: int):
    """GShard top-k dispatch. probs [G,Sg,E] fp32.

    Returns (dispatch [G,Sg,E,C] 0/1, combine [G,Sg,E,C] fp32, aux_loss).
    """
    G, Sg, E = probs.shape
    k = cfg.top_k
    gates, idx = torch.topk(probs, k, dim=-1)                    # [G,Sg,k], descending
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)  # renormalise the chosen
    onehot = F.one_hot(idx, E).to(torch.float32)                 # [G,Sg,k,E]
    # priority: choice rank first, then token order
    flat = onehot.transpose(1, 2).reshape(G, k * Sg, E)
    pos_flat = flat.cumsum(dim=1) - flat                         # position within expert
    pos = pos_flat.reshape(G, k, Sg, E).transpose(1, 2)          # [G,Sg,k,E]
    keep = (pos < cap).to(torch.float32) * onehot                # drop overflow
    pos = pos.clamp(max=cap - 1).to(torch.int64)
    slot = F.one_hot(pos, cap).to(torch.float32) * keep[..., None]
    dispatch = slot.sum(dim=2)                                   # [G,Sg,E,C]
    combine = (slot * gates[..., None, None]).sum(dim=2)         # [G,Sg,E,C]
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                  # mean router prob
    ce = onehot.sum(dim=2).mean(dim=(0, 1))                      # fraction routed
    aux = cfg.num_experts * torch.sum(me * ce)
    return dispatch, combine, aux


def apply_moe(cfg, p, x: torch.Tensor, *, group_size: int = 0):
    """MoE FFN. x [B,S,D] -> ([B,S,D], aux_loss)."""
    if cfg.moe_dispatch == "sort" and current_mesh() is not None:
        raise NotImplementedError("the sort dispatch (distributed/moe_ep.py) is not "
                                  "ported yet (ROADMAP queue 1, item 1)")
    with scope("moe"):
        dt = x.dtype
        tdt = getattr(torch, cfg.moe_table_dtype)
        B, S, D = x.shape
        xg, sg = _group(x, group_size or cfg.moe_group_size)     # [G,Sg,D]
        with scope("router"):
            probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
            dispatch, combine, aux = router_dispatch(cfg, probs, capacity(cfg, sg))
            dispatch, combine = dispatch.to(tdt), combine.to(tdt)
        with scope("dispatch"):
            x_e = torch.einsum("gsec,gsd->gecd", dispatch.to(dt), xg)
            # expert dim onto the model axis (EP); replicated when E does not
            # divide it (mixtral: experts TP'd on moe_mlp)
            x_e = constrain(x_e, ("batch", "model", None, None))
        with scope("experts"):
            g = torch.einsum("gecd,edf->gecf", x_e, p["w_gate"].to(dt))
            u = torch.einsum("gecd,edf->gecf", x_e, p["w_up"].to(dt))
            y_e = torch.einsum("gecf,efd->gecd", F.silu(g) * u, p["w_down"].to(dt))
        with scope("combine"):
            y = constrain(torch.einsum("gsec,gecd->gsd", combine.to(dt), y_e),
                          ("batch", None, None))
        return y.reshape(B, S, D), aux
