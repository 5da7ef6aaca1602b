"""Point-to-point permutation over a process group: the port's
`jax.lax.ppermute`.

    y = ppermute(x, pairs, group)

`pairs` are (source, target) ranks of `group` (group-local, as JAX's pairs
are axis indices).  Each source sends its `x` to its target; a rank that no
pair targets gets zeros; a self pair (i, i) is a local copy, never a send.
Pairs that repeat a source or a target, or name a rank outside the group,
raise.  The gradient is the inverse permutation, as JAX's.

The exchange is the custom op `repro_torch::ppermute(Tensor x, int[] sources,
int[] targets, str group_name)`: its real implementation is one
`dist.batch_isend_irecv` over the group, its fake one an empty tensor of x's
shape, so a step on fake tensors runs it too.  The collective capture
(`repro_torch.core.capture`) records the op as a `collective-permute` with
its pairs; torch's own `permute_tensor` is an all-to-all and would be
recorded without them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import scope as scope_mod


def check_pairs(pairs: Sequence[Tuple[int, int]], n: int) -> List[Tuple[int, int]]:
    """`pairs` as a list of int pairs, after JAX's checks on a permutation of
    `n` ranks: each rank in range, no source and no target twice."""
    out = [(int(s), int(t)) for s, t in pairs]
    bad = sorted({r for p in out for r in p if not 0 <= r < n})
    if bad:
        raise ValueError(f"ppermute pairs name ranks {bad} outside a group of {n}")
    for i, what in ((0, "source"), (1, "target")):
        seen = [p[i] for p in out]
        if len(set(seen)) < len(seen):
            raise ValueError(f"ppermute pairs repeat a {what}: {out}")
    return out


@torch.library.custom_op("repro_torch::ppermute", mutates_args=())
def _ppermute(x: torch.Tensor, sources: List[int], targets: List[int],
              group_name: str) -> torch.Tensor:
    """The exchange: this rank's sends and receives in one batch."""
    pg = dist.distributed_c10d._resolve_process_group(group_name)
    me = dist.get_rank(pg)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, t in zip(sources, targets):
        if s == t:
            if s == me:
                out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(pg, t), pg))
        elif t == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(pg, s), pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


@_ppermute.register_fake
def _(x, sources, targets, group_name):
    return x.new_empty(x.shape)


class _PPermute(torch.autograd.Function):
    """The op with JAX's gradient: the cotangent permuted back."""

    @staticmethod
    def forward(ctx, x, sources, targets, group_name):
        ctx.inverse = (targets, sources, group_name)
        return torch.ops.repro_torch.ppermute(x, sources, targets, group_name)

    @staticmethod
    def backward(ctx, grad):
        return _PPermute.apply(grad, *ctx.inverse), None, None, None


def ppermute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """Send `x` along `pairs` (ranks of the ProcessGroup `group`); see the module."""
    pairs = check_pairs(pairs, dist.get_world_size(group))
    sources = [s for s, _ in pairs]
    targets = [t for _, t in pairs]
    return scope_mod.mark(_PPermute.apply(x, sources, targets, group.group_name))
