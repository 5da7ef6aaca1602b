"""Mixture-of-Experts FFN with top-k routing: the reference's GShard/Switch
einsum dispatch (`repro.models.moe`).

Tokens are cut into groups; in each group a one-hot dispatch table sends
every kept (token, choice) to a slot of its expert, each expert runs its
SwiGLU on its `capacity` slots, and a combine table weighted by the
renormalised gates brings the results back.  Overflow past an expert's
capacity is dropped, in the GShard priority order: choice rank first, then
token order.  The expert dim is constrained onto `model` between dispatch
and the experts; when it is sharded there (EP), each rank runs its own
experts and the combine under `local_map` (`_experts_and_combine`).

`cfg.moe_dispatch == "sort"` takes the sort dispatch
(`distributed/moe_ep.py`) under a current mesh whose `model` size divides
the experts, as the reference's rule does; without a mesh, or with experts
that `model` does not divide, it falls through to this path.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.autoshard import (constrain, constrain_to, current_axes,
                                               current_mesh, role_placements)
from repro_torch.models.meta import ParamMeta
from repro_torch.scope import mark, scope


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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """F.one_hot(idx, n) as fp32, by comparison: no range check reads the
    indices (one_hot's does, which a step on fake tensors cannot)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def router_dispatch(cfg, probs: torch.Tensor, cap: int):
    """GShard top-k dispatch. probs [G,Sg,E] fp32.

    Returns (dispatch [G,Sg,E,C] 0/1, combine [G,Sg,E,C] fp32, aux_loss).
    """
    G, Sg, E = probs.shape
    k = cfg.top_k
    gates, idx = torch.topk(probs, k, dim=-1)                    # [G,Sg,k], descending
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)  # renormalise the chosen
    onehot = _one_hot(idx, E)                                    # [G,Sg,k,E]
    # priority: choice rank first, then token order
    flat = onehot.transpose(1, 2).reshape(G, k * Sg, E)
    pos_flat = flat.cumsum(dim=1) - flat                         # position within expert
    pos = pos_flat.reshape(G, k, Sg, E).transpose(1, 2)          # [G,Sg,k,E]
    keep = (pos < cap).to(torch.float32) * onehot                # drop overflow
    pos = pos.clamp(max=cap - 1).to(torch.int64)
    slot = _one_hot(pos, cap) * keep[..., None]
    dispatch = slot.sum(dim=2)                                   # [G,Sg,E,C]
    combine = (slot * gates[..., None, None]).sum(dim=2)         # [G,Sg,E,C]
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                                  # mean router prob
    ce = onehot.sum(dim=2).mean(dim=(0, 1))                      # fraction routed
    aux = cfg.num_experts * torch.sum(me * ce)
    return dispatch, combine, aux


def apply_moe(cfg, p, x: torch.Tensor, *, group_size: int = 0):
    """MoE FFN. x [B,S,D] -> ([B,S,D], aux_loss)."""
    mesh = current_mesh()
    if (cfg.moe_dispatch == "sort" and mesh is not None
            and cfg.num_experts % current_axes().get("model", 1) == 0):
        from repro_torch.distributed.moe_ep import apply_moe_sort
        with scope("moe"):
            return apply_moe_sort(cfg, p, x, mesh)
    with scope("moe"):
        dt = x.dtype
        tdt = getattr(torch, cfg.moe_table_dtype)
        B, S, D = x.shape
        xg, sg = _group(x, group_size or cfg.moe_group_size)     # [G,Sg,D]
        # the groups split as the batch rows they come from, in forward and in
        # backward (whole where the rows are: a micro-batch smaller than
        # `data`), so that they fold back into [B, S, D]
        rows = None
        if isinstance(x, DTensor):
            rows = (role_placements((B, S, D), ("batch", None, None))
                    or [Replicate()] * x.device_mesh.ndim)
            xg = constrain_to(xg, rows)
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
            w = [p[n].to(dt) for n in ("w_gate", "w_up", "w_down")]
        y = _experts_and_combine(x_e, combine.to(dt), *w)
        with scope("combine"):
            if rows is not None:
                y = constrain_to(y, rows)
        return y.reshape(B, S, D), aux


def _experts(x_e, combine, wg, wu, wd):
    """The experts' SwiGLU on x_e [G,E,C,D] and the combine back to [G,Sg,D]."""
    with scope("experts"):
        g = torch.einsum("gecd,edf->gecf", x_e, wg)
        u = torch.einsum("gecd,edf->gecf", x_e, wu)
        y_e = torch.einsum("gecf,efd->gecd", F.silu(g) * u, wd)
    with scope("combine"):
        return torch.einsum("gsec,gecd->gsd", combine, y_e)


_EP_PLACEMENTS = (Shard(0), Shard(1), Replicate())


def _experts_and_combine(x_e, combine, wg, wu, wd):
    """`_experts`; with the expert dim of a DTensor x_e sharded over a mesh axis
    (EP), on each rank's own experts (`local_map`), as GSPMD partitions it.

    Each rank runs its experts on its groups and contracts them in the
    combine: its output is a partial sum over the expert axis, which the
    combine's constraint reduces.  The weights are gathered over the other
    axes first (FSDP), in the `experts` scope.  (DTensor's einsum would
    flatten the sharded expert dim with the capacity dim, which torch 2.11
    refuses.)"""
    pl = getattr(x_e, "placements", ())
    if Shard(1) not in pl or any(q not in _EP_PLACEMENTS for q in pl):
        return _experts(x_e, combine, wg, wu, wd)
    mesh = x_e.device_mesh

    def per_axis(on_groups, on_experts):
        return tuple(on_groups if q == Shard(0) else on_experts if q == Shard(1)
                     else Replicate() for q in pl)
    w_pl = per_axis(Replicate(), Shard(0))
    with scope("experts"):
        w = [mark(t.redistribute(mesh, w_pl)) for t in (wg, wu, wd)]
    c_pl = per_axis(Shard(0), Shard(2))
    combine = mark(combine.redistribute(mesh, c_pl))
    # gradients: the weights' are partial over the axes that split the groups
    w_grad = per_axis(Partial(), Shard(0))
    return mark(local_map(_experts, out_placements=list(per_axis(Shard(0), Partial())),
                          in_placements=(pl, c_pl, w_pl, w_pl, w_pl),
                          in_grad_placements=(pl, c_pl, w_grad, w_grad, w_grad),
                          device_mesh=mesh)(x_e, combine, *w))
