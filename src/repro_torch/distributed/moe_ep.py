"""Sort-based expert-parallel MoE dispatch (the port of the reference's
`distributed/moe_ep.py`).

The einsum dispatch (`models/moe.py`) builds [G, Sg, E, C] one-hot tables
and pays einsum FLOPs that grow with Sg^2 for dispatch and combine.  This
path instead:

  * runs per rank (`local_map`), as the reference runs it per shard under
    `shard_map`: tokens are sharded over the data axes (`pod`, `data`) and
    replicated over `model`; the router is replicated; `w_gate`, `w_up`
    and `w_down` are sharded over `model` on the expert dim;
  * top-k routes in fp32, sorts the token slots by expert (stable), finds
    each slot's position in its expert's run by `searchsorted`, and keeps
    the slots under a global per-shard capacity ceil(k·T·capacity_factor/E);
  * scatter-adds this rank's kept slots into its local experts' [E_loc·C+1, D]
    buffer (the last row takes every dropped or foreign slot), runs the
    three expert products in the working dtype, and scatter-adds the
    gate-weighted results back to their tokens in fp32.

No all-to-all is needed on this layout: every rank holds all of its data
shard's tokens, so each `model` rank computes its E/model experts on the
same token set and contributes a partial [T, D] sum.  The one collective is
the sum of those fp32 partials over `model`, inside the `moe/combine`
scope: the per-rank output is declared `Partial` over `model` and
redistributed to replicated there, which also carries its gradient (the
weights' gatherings at the `moe` scope are the sharding's, FSDP's over the
data axes, of the experts cast to the working dtype on their shards, as the
port's other layers gather theirs).  Requires E % model == 0 (`models/moe.py` falls through to the
einsum dispatch otherwise).

The aux loss is the Switch loss of each data shard's tokens (ce sums to k
over experts), averaged over the data shards: the output is declared
`Partial` with each rank's share and summed at the `moe/router` scope (one
scalar).  The reference returns its aux as
replicated although each data shard computes its own, so its value is one
shard's while its gradient is that of this mean; the port's value is the
mean, whose gradient it takes.

Capacity is global per data shard, where the einsum dispatch's is per
routing group; with a no-drop capacity factor (E/k) the two paths agree.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.scope import mark, scope

DATA_AXES = ("pod", "data")


def _moe_shard(xl, router, wg, wu, wd, *, cfg, e_loc: int, m_idx: int, shares: int):
    """One rank's MoE: xl [b, S, D] (its data shard's tokens, whole over
    `model`); wg/wu/wd hold this rank's E_loc experts.  Returns the fp32
    partial output [b, S, D] and this rank's share of the aux loss."""
    B, S, D = xl.shape
    dt, k, E = xl.dtype, cfg.top_k, cfg.num_experts
    T = B * S
    xf = xl.reshape(T, D)

    with scope("router"):
        probs = torch.softmax(xf.float() @ router.float(), dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)                    # [T, k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        # aux load-balance loss (Switch; as the einsum path: ce sums to k)
        me = probs.mean(dim=0)
        ce = torch.bincount(idx.reshape(-1), minlength=E).to(torch.float32) / T
        aux = E * torch.sum(me * ce)

    with scope("dispatch"):
        cap = max(1, math.ceil(k * T * cfg.capacity_factor / E))
        flat_e = idx.reshape(-1)                                     # [T*k]
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        tok_sorted = order // k
        gate_sorted = gates.reshape(-1)[order]
        # position within each expert's run of the sorted array
        first = torch.searchsorted(e_sorted, e_sorted, side="left")
        pos = torch.arange(T * k, device=xl.device) - first
        lo = m_idx * e_loc
        local = (pos < cap) & (e_sorted >= lo) & (e_sorted < lo + e_loc)
        dump = e_loc * cap                                           # overflow row
        dest = torch.where(local, (e_sorted - lo) * cap + pos, dump)
        vals = torch.where(local[:, None], xf[tok_sorted], 0).to(dt)
        buf = torch.zeros(e_loc * cap + 1, D, dtype=dt, device=xl.device).index_add(
            0, dest, vals)
        x_e = buf[:e_loc * cap].reshape(e_loc, cap, D)

    with scope("experts"):
        g = torch.einsum("ecd,edf->ecf", x_e, wg.to(dt))
        u = torch.einsum("ecd,edf->ecf", x_e, wu.to(dt))
        y_e = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd.to(dt))

    with scope("combine"):
        flat_y = torch.cat([y_e.reshape(e_loc * cap, D),
                            torch.zeros(1, D, dtype=dt, device=xl.device)])
        y_slot = flat_y[dest] * gate_sorted[:, None].to(dt)
        y_tok = torch.zeros(T, D, dtype=torch.float32, device=xl.device).index_add(
            0, tok_sorted, torch.where(local[:, None], y_slot, 0).float())
    return y_tok.reshape(B, S, D), aux / shares


def _as_dtensor(t, mesh):
    """A plain tensor met on the mesh counts as replicated (as under
    `implicit_replication`)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def apply_moe_sort(cfg, p, x, mesh):
    """The sort dispatch on `mesh` (a DeviceMesh). x [B, S, D] -> ([B, S, D], aux).
    Requires E % model == 0."""
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.mesh.shape))
    model = sizes.get("model", 1)
    if cfg.num_experts % model:
        raise ValueError(f"{cfg.num_experts} experts do not divide model={model}")
    data = [a for a in names if a in DATA_AXES]
    shares = math.prod(mesh.mesh.shape)          # aux: mean over data, whole over model

    def on(dim_of_axis):
        return tuple(dim_of_axis.get(a, Replicate()) for a in names)

    tokens = on({a: Shard(0) for a in data})                      # x: tokens over data
    whole = on({})                                                # router replicated
    experts = on({"model": Shard(0)})                             # experts over model
    # gradients: x's is partial over model (each rank routes through its own
    # experts); the router's and the experts' are partial over the data axes
    # (each rank sees its own tokens), the router's over model too
    x_grad = on({**{a: Shard(0) for a in data}, "model": Partial()})
    router_grad = on({a: Partial() for a in names})
    expert_grad = on({**{a: Partial() for a in data}, "model": Shard(0)})
    # the experts are cast to the working dtype on their shards, then gathered
    # (the router stays fp32)
    args = [_as_dtensor(x, mesh).redistribute(mesh, tokens),
            _as_dtensor(p["router"], mesh).redistribute(mesh, whole)]
    args += [_as_dtensor(p[n], mesh).to(x.dtype).redistribute(mesh, experts)
             for n in ("w_gate", "w_up", "w_down")]
    m_idx = mesh.get_local_rank("model") if "model" in names else 0
    fn = local_map(
        lambda *a: _moe_shard(*a, cfg=cfg, e_loc=cfg.num_experts // model, m_idx=m_idx,
                              shares=shares),
        out_placements=(on({**{a: Shard(0) for a in data}, "model": Partial()}),
                        on({a: Partial() for a in names})),
        in_placements=(tokens, whole, experts, experts, experts),
        in_grad_placements=(x_grad, router_grad, expert_grad, expert_grad, expert_grad),
        device_mesh=mesh)
    y, aux = (mark(t) for t in fn(*[mark(a) for a in args]))
    with scope("router"):
        # one mesh dim at a time (model, then the data axes): the same two
        # sums DTensor would run for both at once
        aux = mark(aux.redistribute(mesh, on({a: Partial() for a in data})))
        aux = mark(aux.redistribute(mesh, whole))
    with scope("combine"):
        y = mark(y.redistribute(mesh, tokens)).to(x.dtype)
    return y, aux
