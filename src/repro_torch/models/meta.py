"""Parameter metadata: one abstract tree drives init and parameter counts.

Models declare a tree of `ParamMeta` leaves (shape + logical axis names);
`materialize` turns it into tensors.  Trees are nested dicts and lists (the
port keeps one dict per layer in a list where the reference stacks layers).
Logical axis names are kept for the sharding slice; one card ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | constant | a_log
    scale: Optional[float] = None        # stddev override (default: fan-in); constant's value
    # storage dtype; None means the params' dtype.  A leaf that the reference
    # reads as fp32 at every use (`.astype(float32)`) says "float32"
    dtype: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def tree_map_meta(fn, tree, prefix=()):
    """Map over ParamMeta leaves, passing (path, meta); list items add str(i)."""
    if is_meta(tree):
        return fn(prefix, tree)
    if isinstance(tree, list):
        return [tree_map_meta(fn, v, prefix + (str(i),)) for i, v in enumerate(tree)]
    return {k: tree_map_meta(fn, v, prefix + (k,)) for k, v in tree.items()}


def leaves(tree):
    """ParamMeta (or tensor) leaves of a dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """fn over the leaves of dict/list trees of one structure (the first's)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _fold_path(seed: int, path: Tuple[str, ...]) -> int:
    """The reference's FNV-1a fold of the path, mixed with the seed into 32
    bits (the CPU generator keeps only the low 32 bits of a seed)."""
    h = 2166136261
    for part in path:
        for ch in part.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return (h ^ (seed * 0x9E3779B1)) & 0xFFFFFFFF


def materialize(tree, seed: int, device: torch.device, dtype: torch.dtype, place=None):
    """Initialize a params tree from a meta tree.

    `place(path, tensor)`, when given, maps each leaf as soon as it exists
    (on a mesh: to its shard), so no more than one whole leaf is held.

    Each normal leaf is drawn in fp32 from its own `torch.Generator` on
    `device`, seeded by `_fold_path(seed, path)`, then cast to `dtype` (or
    to the leaf's own `ParamMeta.dtype`).  The numbers differ from the reference's `jax.random` draws (and between CPU
    and CUDA generators); parity tests load reference weights through
    `repro_torch.bridge` instead.
    """

    def init_one(path, m: ParamMeta):
        dt = leaf_dtype(m, dtype)
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dt, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dt, device=device)
        if m.init == "constant":
            return torch.full(m.shape, m.scale or 0.0, dtype=dt, device=device)
        if m.init == "a_log":
            # S4D-real init: A = -(1..N) per state channel
            a = torch.arange(1, m.shape[-1] + 1, dtype=torch.float32, device=device)
            return torch.log(a).expand(m.shape).contiguous().to(dt)
        if m.init != "normal":
            raise ValueError(f"unknown init {m.init!r}")
        fan_in = m.shape[-2] if len(m.shape) >= 2 else m.shape[-1]
        scale = m.scale if m.scale is not None else fan_in ** -0.5
        gen = torch.Generator(device=device).manual_seed(_fold_path(seed, path))
        w = torch.randn(m.shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dt)

    if place is None:
        return tree_map_meta(init_one, tree)
    return tree_map_meta(lambda path, m: place(path, init_one(path, m)), tree)


def leaf_dtype(m: ParamMeta, dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is stored in when the params take `dtype`."""
    return getattr(torch, m.dtype) if m.dtype else dtype


def param_count(tree) -> int:
    return sum(int(np.prod(m.shape)) for m in leaves(tree))
