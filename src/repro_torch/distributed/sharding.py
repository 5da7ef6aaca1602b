"""Logical-axis -> mesh-axis sharding rules (DP/FSDP/TP/EP/SP), on a
`torch.distributed` DeviceMesh (the port of the reference's
`distributed/sharding.py`).

Every parameter declares *logical* axes (`embed`, `heads`, `mlp`, `expert`,
...).  Rules map each logical axis to an ordered list of candidate mesh-axis
tuples; the first candidate whose axes (a) exist in the mesh, (b) are not
already used by another dim of the same tensor, and (c) divide the dimension
evenly, wins.  This gives:

  * FSDP/ZeRO-3: `embed`/`in_vocab` sharded over (pod, data),
  * TP:          `heads`/`kv_heads`/`mlp`/`vocab`/`inner` over `model`,
  * EP:          `expert` over `model` when E divides it (qwen3: 128/16),
                 falling back to ffn-TP inside experts (mixtral: 8 < 16),
  * SP:          long-context KV/state sharded over leftover axes.

Archs whose dims don't divide an axis degrade gracefully to replication —
the capture prices the resulting traffic, which is the whole point.

The rule tables and `spec_for`/`shard_dim` are the reference's.  A spec is
a `PartitionSpec`: a tuple with one entry per tensor dim, `None`, a mesh
axis name, or a tuple of names (the reference's `jax.sharding.PartitionSpec`
entries).  `placements_for` turns a spec into DTensor placements, one per
mesh dim: `Shard(d)` where the spec puts that mesh axis on tensor dim d,
else `Replicate()`.  The port keeps one dict per layer where the reference
stacks layers, so a layer's spec lacks the reference's leading `layers`
entry (always `None`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from repro_torch.models import api as model_api
from repro_torch.models.meta import tree_map, tree_map_meta

Rules = Dict[str, Tuple[Tuple[str, ...], ...]]

# DP/FSDP axis preference: pod+data jointly, else data alone.
_FSDP = (("pod", "data"), ("data",))
# HSDP: shard within the pod, replicate across pods — per-layer weight
# gathers stay inside the pod; the cross-pod links carry one gradient
# all-reduce per step instead of per-layer-per-microbatch gathers.
_FSDP_HIER = (("data",), ("pod", "data"))
_TP = (("model",),)

TRAIN_RULES: Rules = {
    "embed": _FSDP,
    # the input table shards along d_model (embed_tp) only, as in the
    # reference (whose partitioner cannot split a gather along the indexed
    # dim); a D-sharded table makes the lookup comm-free anyway.
    "in_vocab": (),
    "heads": _TP,
    "kv_heads": _TP,
    "mlp": _TP,
    "moe_mlp": _TP,
    "inner": _TP,
    "vocab": _TP,
    "embed_tp": _TP,
    "expert": _TP,
    "layers": (),
}

# Serving: weights stay FSDP-sharded for frontier configs (weight-gather
# amortized over the batch); small models replicate over data.
SERVE_RULES_FSDP: Rules = TRAIN_RULES
SERVE_RULES_REPLICATED: Rules = {**TRAIN_RULES, "embed": ()}

TRAIN_RULES_HSDP: Rules = {**TRAIN_RULES, "embed": _FSDP_HIER}

BATCH_AXES = (("pod", "data"), ("data",))


class PartitionSpec(tuple):
    """Per-dim mesh-axis assignment: `None`, an axis name, or a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of a `core.topology.MeshSpec`)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axes, mesh.shape))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: Rules, axis_sizes: Dict[str, int]) -> P:
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical):
        chosen: Optional[Tuple[str, ...]] = None
        if name is not None:
            for cand in rules.get(name, ()):
                if not cand:
                    continue
                if any(a not in axis_sizes for a in cand):
                    continue
                if used & set(cand):
                    continue
                prod = int(np.prod([axis_sizes[a] for a in cand]))
                if dim % prod == 0:
                    chosen = cand
                    break
        if chosen:
            used |= set(chosen)
            parts.append(chosen[0] if len(chosen) == 1 else chosen)
        else:
            parts.append(None)
    return P(*parts)


def shard_dim(dim: int, candidates, axis_sizes: Dict[str, int],
              used: set) -> Optional[Tuple[str, ...]]:
    for cand in candidates:
        if not cand or any(a not in axis_sizes for a in cand) or (used & set(cand)):
            continue
        prod = int(np.prod([axis_sizes[a] for a in cand]))
        if dim % prod == 0:
            return cand
    return None


# --------------------------------------------------------------------------
# model-level sharding trees
# --------------------------------------------------------------------------

def param_pspecs(cfg, mesh, rules: Rules = TRAIN_RULES):
    sizes = mesh_axis_sizes(mesh)
    return tree_map_meta(lambda _p, m: spec_for(m.shape, m.logical, rules, sizes),
                         model_api.model_meta(cfg))


def opt_state_pspecs(cfg, mesh, rules: Rules = TRAIN_RULES):
    ps = param_pspecs(cfg, mesh, rules)
    return {"m": ps, "v": ps, "count": P()}


def batch_pspecs(cfg, shape, mesh):
    """PartitionSpecs for the train/prefill batch dict (`api.batch_specs`)."""
    sizes = mesh_axis_sizes(mesh)
    b_axes = shard_dim(shape.global_batch, BATCH_AXES, sizes, set())
    bspec = (b_axes[0] if len(b_axes) == 1 else b_axes) if b_axes else None
    out = {}
    for key, spec in model_api.batch_specs(cfg, shape).items():
        if key == "positions":            # [3, B, S]
            out[key] = P(None, bspec, None)
        else:
            out[key] = P(*([bspec] + [None] * (len(spec.shape) - 1)))
    return out


def _cache_entry_pspecs(entry, B, sizes, stacked: bool):
    """PartitionSpecs for one cache entry (leading L dim when stacked)."""
    lead = (None,) if stacked else ()
    e: Dict[str, P] = {}
    used: set = set()
    b_axes = shard_dim(B, BATCH_AXES, sizes, used)
    if b_axes:
        used |= set(b_axes)
    bspec = (b_axes[0] if len(b_axes) == 1 else b_axes) if b_axes else None
    off = 1 if stacked else 0
    for key, sds in entry.items():
        if key in ("k", "v", "cross_k", "cross_v"):
            sc = sds.shape[1 + off]
            s_cands = (("model",),) if b_axes else \
                (("data", "model"), ("model",), ("data",))
            s_axes = shard_dim(sc, s_cands, sizes, used)
            sspec = None
            if s_axes:
                sspec = s_axes[0] if len(s_axes) == 1 else s_axes
            e[key] = P(*lead, bspec, sspec, None, None)
        elif key == "conv":           # [B, dc-1, di]
            di_axes = shard_dim(sds.shape[2 + off], _TP, sizes, used)
            e[key] = P(*lead, bspec, None, di_axes[0] if di_axes else None)
        elif key == "ssm":            # [B, di, N]
            di_axes = shard_dim(sds.shape[1 + off], _TP, sizes, used)
            e[key] = P(*lead, bspec, di_axes[0] if di_axes else None, None)
        else:
            e[key] = P(*([None] * len(sds.shape)))
    return e


def cache_pspecs(cfg, shape, mesh):
    """Decode-cache PartitionSpecs (stacked dict or per-layer list).

    Prefers batch-sharding over (pod, data) and sequence-sharding over
    `model`; at 500k ctx with batch 1 the sequence takes every available
    axis (SP).  SSM state shards its channel dim over `model`.
    """
    sizes = mesh_axis_sizes(mesh)
    B = shape.global_batch
    specs_in = model_api.cache_specs(cfg, shape)
    if isinstance(specs_in, dict):
        return _cache_entry_pspecs(specs_in, B, sizes, stacked=True)
    return [_cache_entry_pspecs(entry, B, sizes, stacked=False)
            for entry in specs_in]


def lint_sharding(cfg, mesh, rules: Rules = TRAIN_RULES, shape=None):
    """Static pre-trace lint of a model's sharding plan on a mesh.

    Runs `commcheck.lint_pspecs` over the `param_pspecs` tree (with the
    real parameter shapes from the meta tree, so divisibility and
    unsharded-dominant-dim checks apply) and, when a `shape` is given,
    over `batch_pspecs` too.  Returns findings ranked by severity then
    tensor bytes at stake — catch a bad spec before running anything.
    """
    from repro_torch.core import commcheck
    from repro_torch.core.detect import rank_findings

    sizes = mesh_axis_sizes(mesh)
    shapes = tree_map_meta(lambda _p, m: tuple(m.shape), model_api.model_meta(cfg))
    out = commcheck.lint_pspecs(param_pspecs(cfg, mesh, rules), sizes,
                                shapes=shapes, prefix="params")
    if shape is not None:
        out += commcheck.lint_pspecs(batch_pspecs(cfg, shape, mesh), sizes,
                                     prefix="batch")
    return rank_findings(out)


def serve_rules_for(cfg, mesh) -> Rules:
    """Replicate weights over DP axes only when they comfortably fit."""
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    bytes_per_dev = model_api.param_count(cfg) * 2 / tp   # bf16 serving
    return SERVE_RULES_REPLICATED if bytes_per_dev < 4e9 else SERVE_RULES_FSDP


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------

def placements_for(spec: Sequence, mesh) -> List[Placement]:
    """One placement per mesh dim: Shard(d) where `spec` puts that mesh axis on
    tensor dim d, else Replicate().  A dim sharded over two axes (("pod",
    "data")) is split in mesh-dim order, the reference's device order."""
    out: List[Placement] = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def param_placements(cfg, mesh, rules: Rules = TRAIN_RULES):
    """The params tree of DTensor placements (`param_pspecs` on `mesh`)."""
    return tree_map(lambda s: placements_for(s, mesh), param_pspecs(cfg, mesh, rules))


def distribute_params(params, mesh, placements):
    """Each full tensor of `params` as a DTensor with its `placements`.  Every
    rank holds the same full tensors (params come from a seed, or from a
    checkpoint), so each keeps its own shard and nothing is communicated."""
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None),
                    params, placements)


def init_params(cfg, seed: int, mesh, *, dtype=torch.float32, rules: Rules = TRAIN_RULES):
    """`api.init_params` on the mesh's device, each leaf distributed by
    `param_placements` as soon as it is made: one whole leaf at a time."""
    sizes, placements = mesh_axis_sizes(mesh), {}

    def record(path, m):
        placements[path] = placements_for(spec_for(m.shape, m.logical, rules, sizes), mesh)
    tree_map_meta(record, model_api.model_meta(cfg))

    def place(path, t):
        return distribute_tensor(t, mesh, placements[path], src_data_rank=None)
    return model_api.init_params(cfg, seed, device=mesh.device_type, dtype=dtype, place=place)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (gathered), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
