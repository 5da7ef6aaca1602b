"""Pipeline parallelism: GPipe micro-batch streaming over a mesh axis (the
reference's `distributed/pipeline.py`, on a `torch.distributed` process group).

Each stage owns a contiguous slice of layers; micro-batches stream stage to
stage by a neighbour `ppermute` (the `collective-permute` chain the capture
classifies as `pipeline` traffic).  The schedule runs M + P - 1 ticks: at
tick t stage 0 takes micro-batch t and the last stage retires micro-batch
t - (P - 1).  Every stage runs its layers at every tick, as the reference's
SPMD program does; the bubble fraction (P - 1) / (M + P - 1) is the textbook
GPipe overhead.  The last tick's hop, whose result nothing reads, is not
sent (XLA drops it from the reference's program: M + P - 2 hops); with one
stage there is neither hop nor final all-reduce.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_map

from repro_torch.distributed.algorithms import builtin_allreduce
from repro_torch.distributed.ppermute import ppermute
from repro_torch.scope import scope


def _stage_row(a, idx: int, axis: str):
    """This stage's slice of a leaf with leading dim P: row `idx` of a plain
    tensor, or the local shard of a DTensor placed Shard(0) on `axis`."""
    if not isinstance(a, DTensor):
        return a[idx]
    placement = a.placements[a.device_mesh.mesh_dim_names.index(axis)]
    local = a.to_local()
    if placement != Shard(0) or local.shape[0] != 1:
        raise ValueError(f"a stage parameter DTensor must be Shard(0) on {axis!r} with one "
                         f"row a rank, not {a.placements} with local {tuple(local.shape)}")
    return local[0]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """Run micro-batches through the P stages of `mesh`'s axis `axis`.

    stage_fn(params_slice, h) -> h      (one stage's layers)
    stage_params: pytree whose leaves have leading dim P (one row a stage)
    x_micro:      [M, mb, ...] micro-batches, the same on every rank
    Returns y [M, mb, ...] after all P stages, on every rank.
    """
    p_size = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    M = x_micro.shape[0]
    ticks = M + p_size - 1
    fwd_perm = [(i, i + 1) for i in range(p_size - 1)]
    params_me = tree_map(lambda a: _stage_row(a, idx, axis), stage_params)

    buf = torch.zeros_like(x_micro[0])             # stage input register
    out = torch.zeros_like(x_micro)
    for t in range(ticks):
        # stage 0 injects micro-batch t; the others take the received buffer
        h_in = x_micro[min(t, M - 1)] if idx == 0 else buf
        with scope("pipeline_stage"):
            h_out = stage_fn(params_me, h_in)
        # the last stage retires micro-batch t - (P-1) at tick t
        retire = t - (p_size - 1)
        if 0 <= retire < M and idx == p_size - 1:
            out[retire] = h_out
        if fwd_perm and t < ticks - 1:
            with scope("pipeline_hop"):
                buf = ppermute(h_out, fwd_perm, group)
    if p_size == 1:
        return out
    # the results live on the last stage; an all-reduce gives them to every stage
    return builtin_allreduce(out, group)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
