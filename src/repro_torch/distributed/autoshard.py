"""Activation sharding constraints with graceful degradation (the port of
the reference's `distributed/autoshard.py`).

Model code calls `constrain(x, roles)` with *roles* ("batch" / "model" /
"seq"), not axis names.  The step driver runs the step inside
`activation_sharding(mesh)`; outside that context (one card, no mesh)
constraints are no-ops, so the same model code runs everywhere.

A constraint here is a DTensor `redistribute` to the placements `_pick`
chooses: where the reference tells GSPMD what layout to reach, the port
moves the tensor there now, and the capture records the collective that
costs.  As JAX's `with_sharding_constraint` does, it also constrains the
gradient in backward to the same layout (`_Constrain`): a gradient left
partial over `model` by a column-parallel product is reduced at the
constraint, where the reference reduces it.  A plain tensor (one that never met a sharded parameter) is left as
it is.  Divisibility is checked per dim, so e.g. batch=1 at 500k decode or
whisper's 51865 vocab silently degrade to replicated instead of erroring.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.scope import mark

# The mesh of the step being run.  Process-wide, where the reference keeps a
# ContextVar: autograd runs backward, and with it a remat's recompute of the
# forward, on its own threads for CUDA tensors, and those threads must see
# the same constraints as the forward.
_ACTIVE: Optional[dict] = None

ROLE_CANDIDATES = {
    "batch": (("pod", "data"), ("data",)),
    "model": (("model",),),
    "seq": (("model",), ("data",)),
    "seq_mp": (("data", "model"), ("model",), ("data",)),
}


@contextmanager
def activation_sharding(mesh, *, seq_shard: bool = False):
    """Enable activation constraints for code run inside this context, where
    plain tensors that meet a DTensor (masks, positions, scalars) count as
    replicated on the mesh.

    `seq_shard=True` turns on Megatron-SP-style sequence sharding of the
    residual stream over the `model` axis (the gather/scatter around each
    layer is the SP exchange, priced by the capture).
    """
    global _ACTIVE
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    outer, _ACTIVE = _ACTIVE, {"sizes": sizes, "seq_shard": seq_shard, "mesh": mesh}
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE = outer


def local_shape_and_offset(global_shape, mesh, placements):
    """This rank's shard of a tensor of `global_shape` placed by `placements`:
    (its shape, the global index of its first element), from the mesh's
    coordinate, outside any fake mode (the rank table is a plain tensor)."""
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(global_shape, mesh, tuple(placements))


def current_mesh():
    return _ACTIVE["mesh"] if _ACTIVE else None


def current_axes() -> Optional[Dict[str, int]]:
    return _ACTIVE["sizes"] if _ACTIVE else None


def _pick(dim: int, role: Optional[str], sizes: Dict[str, int], used: set):
    if role is None:
        return None
    for cand in ROLE_CANDIDATES.get(role, ()):
        if any(a not in sizes for a in cand) or (used & set(cand)):
            continue
        prod = int(np.prod([sizes[a] for a in cand]))
        if dim % prod == 0 and dim >= prod:
            return cand
    return None


class _Constrain(torch.autograd.Function):
    """Redistribute to `placements` in forward, and the gradient to the same
    placements in backward (the transpose of a sharding constraint)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def role_placements(shape: Sequence[int], roles: Sequence[Optional[str]]):
    """The placements, one per dim of the active mesh, that the per-dim roles
    give a tensor of `shape`: Shard(d) on the axes picked for dim d, Replicate
    elsewhere.  None outside `activation_sharding` or when no role applies."""
    ctx = _ACTIVE
    if not ctx:
        return None
    sizes, mesh = ctx["sizes"], ctx["mesh"]
    used: set = set()
    dim_of = {}
    for d, (size, role) in enumerate(zip(shape, roles)):
        cand = _pick(size, role, sizes, used)
        if cand:
            used |= set(cand)
            dim_of.update({a: d for a in cand})
    if not dim_of:
        return None
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def constrain_to(x, placements):
    """Redistribute a DTensor to `placements` on the active mesh, and its
    gradient too (`_Constrain`)."""
    return mark(_Constrain.apply(x, _ACTIVE["mesh"], tuple(placements)))


def constrain_or_whole(x, roles: Sequence[Optional[str]]):
    """`constrain`, but where no role applies x is made whole on every axis
    (`constrain` would leave it as it is)."""
    if not _ACTIVE or not isinstance(x, DTensor):
        return x
    return constrain_to(x, role_placements(x.shape, roles)
                        or [Replicate()] * len(_ACTIVE["mesh"].mesh_dim_names))


def constrain(x, roles: Sequence[Optional[str]]):
    """Redistribute a DTensor to the per-dim roles' placements (a no-op
    outside `activation_sharding` and on a plain tensor)."""
    if not _ACTIVE or not isinstance(x, DTensor):
        return x
    placements = role_placements(x.shape, roles)
    if placements is None:  # no role applies: left unconstrained, as in the reference
        return x
    return constrain_to(x, placements)


def constrain_residual(x):
    """[B, S, D] activations (+ optional SP sequence sharding).  Where no role
    applies (a batch that `data` does not divide: decode's single row, a
    micro-batch smaller than `data`) the residual stream is whole on every
    rank: left to itself it drifts into whatever layout each product leaves,
    which torch 2.11's DTensor cannot always add (a partial sum to a split)."""
    seq_role = "seq" if (_ACTIVE and _ACTIVE["seq_shard"]) else None
    return constrain_or_whole(x, ("batch", seq_role, None))


def constrain_logits(x):
    """[B, S, V] logits (vocab TP when divisible)."""
    return constrain(x, ("batch", None, "model"))
