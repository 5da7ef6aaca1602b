"""Explicit all-reduce algorithms over one mesh axis (the reference's
`distributed/algorithms.py`, on a `torch.distributed` process group).

The paper's Fig 5 compares Open MPI's and MPICH's Allreduce variants
(recursive doubling, reduce-scatter + all-gather, ring) by their traced
communication patterns.  The same three algorithms are written out here, so
that the capture shows their distinct signatures, beside c10d's built-in
all-reduce (NCCL on the card, gloo on the CPU; the reference's "xla"):

  * `ring_allreduce`: n - 1 reduce-scatter hops, then n - 1 all-gather hops,
    each a 1/n-payload `ppermute` to the next rank (scopes `ring_rs_hop`,
    `ring_ag_hop`); the payload is padded to a multiple of n;
  * `rsag_allreduce`: a reduce-scatter and an all-gather (`rsag_rs`,
    `rsag_ag`);
  * `recursive_doubling_allreduce`: log2 n full-payload exchanges with rank
    i XOR 2^k (`recdbl_round{k}`), power-of-two groups only.

Each takes the rank's local tensor and the axis's ProcessGroup.
`allreduce_fn(algorithm, mesh, axis_name)` runs one on the rank's local
shard, or on a DTensor's, and gives a DTensor back with its placements.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.ppermute import ppermute
from repro_torch.scope import scope

_C10D = torch.ops._c10d_functional


def _padded(x: torch.Tensor, n: int):
    """x flattened and zero-padded to a multiple of n, and the pad."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    return (F.pad(flat, (0, pad)) if pad else flat), pad


def _unpadded(out: torch.Tensor, pad: int, x: torch.Tensor) -> torch.Tensor:
    out = out.reshape(-1)
    if pad:
        out = out[:out.numel() - pad]
    return out.reshape(x.shape)


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Textbook ring: n-1 reduce-scatter hops + n-1 all-gather hops, one
    1/n-payload neighbour ppermute per hop."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    perm = [(i, (i + 1) % n) for i in range(n)]
    flat, pad = _padded(x, n)
    chunks = flat.reshape(n, -1)                     # local copy of each chunk

    # reduce-scatter phase: rank i ends up owning the full sum of chunk (i+1) mod n
    carry = chunks[idx]
    for s in range(n - 1):
        with scope("ring_rs_hop"):
            carry = ppermute(carry, perm, group)
            carry = carry + chunks[(idx - s - 1) % n]
    owned = (idx + 1) % n

    # all-gather phase: circulate the reduced chunks
    out = torch.zeros_like(chunks)
    out[owned] = carry
    cur = carry
    for s in range(n - 1):
        with scope("ring_ag_hop"):
            cur = ppermute(cur, perm, group)
            src_owner = (idx - s - 1) % n
            out[(src_owner + 1) % n] = cur
    return _unpadded(out, pad, x)


def builtin_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """c10d's all-reduce (the backend's own schedule)."""
    return _C10D.wait_tensor(_C10D.all_reduce(x, "sum", group.group_name))


def rsag_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """reduce-scatter + all-gather via the dedicated collectives."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat, pad = _padded(x, n)
    with scope("rsag_rs"):
        scattered = _C10D.wait_tensor(
            _C10D.reduce_scatter_tensor(flat, "sum", n, group.group_name))
    with scope("rsag_ag"):
        gathered = _C10D.wait_tensor(
            _C10D.all_gather_into_tensor(scattered, n, group.group_name))
    return _unpadded(gathered, pad, x)


def recursive_doubling_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """log2(n) exchange rounds with the partner at distance 2^k (full payload)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError(f"recursive doubling needs a power-of-two group, not {n}")
    out = x
    for k in range(int(math.log2(n))):
        d = 1 << k
        perm = [(i, i ^ d) for i in range(n)]
        with scope(f"recdbl_round{k}"):
            out = out + ppermute(out, perm, group)
    return out


ALGORITHMS = {
    "builtin": builtin_allreduce,      # c10d's all-reduce (baseline; the reference's "xla")
    "ring": ring_allreduce,
    "rsag": rsag_allreduce,
    "recursive_doubling": recursive_doubling_allreduce,
}


def allreduce_fn(algorithm: str, mesh, axis_name: str = "data"):
    """The all-reduce `algorithm` over `mesh`'s axis `axis_name`, as a function
    of the rank's local tensor (or of a DTensor sharded on that axis, whose
    local shard it reduces; the result keeps its placements)."""
    fn = ALGORITHMS[algorithm]
    group = mesh.get_group(axis_name)

    def run(x):
        if isinstance(x, DTensor):
            return DTensor.from_local(fn(x.to_local(), group), x.device_mesh, x.placements,
                                      shape=x.shape, stride=x.stride())
        return fn(x, group)

    return run
