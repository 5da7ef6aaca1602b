"""Static lint of sharding specs (the spec family of the reference's
`core/commcheck.py`, copied; the trace-level families come with the
profiler's back half).

`lint_pspecs` validates a tree of per-dimension mesh-axis specs against the
mesh: an axis used twice in one spec (`pspec_dup_axis`), spec axes absent
from the mesh (`pspec_unknown_axis`), dims not divisible by their axis
product (`pspec_indivisible`), and unsharded dominant dims while mesh axes
sit idle (`pspec_unsharded_dim`).  Specs are duck-typed: any iterable of
`None | str | tuple[str, ...]` entries (the port's specs are plain tuples).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.detect import Finding

__all__ = ["lint_pspecs"]

_ADVICE: Dict[str, str] = {
    "pspec_dup_axis": "use each mesh axis in at most one dim of the spec",
    "pspec_unknown_axis": "name only axes the mesh defines",
    "pspec_indivisible": "pad the dim or pick axes whose product divides it",
    "pspec_unsharded_dim": "shard the dominant dim over the idle axes",
}


def _fmt_time(t: float) -> str:
    """Human-scaled duration ("3.20 ms")."""
    t = float(t)
    if abs(t) >= 1.0:
        return f"{t:.2f} s"
    if abs(t) >= 1e-3:
        return f"{t * 1e3:.2f} ms"
    return f"{t * 1e6:.0f} us"


def _advise(findings: List[Finding]) -> List[Finding]:
    """Attach the fix advice + unblocked-time figure to each finding."""
    for f in findings:
        if f.recommendation:
            continue
        advice = _ADVICE.get(f.detector)
        if advice is None:
            continue
        f.est_saved_s = f.time_at_risk_s
        f.recommendation = advice if f.time_at_risk_s == 0 else \
            f"{advice} — unblocks est {_fmt_time(f.time_at_risk_s)}/step"
    return findings


def _default_is_leaf(x) -> bool:
    return type(x).__name__ == "PartitionSpec"


def _walk_specs(tree, shapes, path: str, is_leaf):
    if tree is None:
        return
    if is_leaf(tree):
        yield path, tree, shapes
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub = shapes.get(k) if isinstance(shapes, dict) else None
            yield from _walk_specs(v, sub, f"{path}/{k}" if path else str(k),
                                   is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = shapes[i] if isinstance(shapes, (list, tuple)) \
                and i < len(shapes) else None
            yield from _walk_specs(v, sub, f"{path}/{i}" if path else str(i),
                                   is_leaf)
    else:
        # unknown leaf type: treat as spec-like (iterable of entries)
        yield path, tree, shapes


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def lint_pspecs(pspecs, axis_sizes: Dict[str, int], shapes=None, *,
                big_dim: int = 4096, is_leaf=None,
                prefix: str = "") -> List[Finding]:
    """Statically validate a PartitionSpec tree against mesh axis sizes.

    `pspecs` is any nesting of dict/list/tuple with PartitionSpec-like
    leaves (anything iterating as `None | str | tuple[str, ...]` entries
    — duck-typed, so plain tuples work in jax-free tests via `is_leaf`).
    `shapes`, when given, mirrors the tree with per-leaf dim tuples and
    enables the divisibility and unsharded-dominant-dim checks.
    `wasted_bytes` ranks spec findings by f32 tensor bytes at stake.
    """
    if is_leaf is None:
        is_leaf = _default_is_leaf
    out: List[Finding] = []
    for path, spec, shape in _walk_specs(pspecs, shapes, prefix, is_leaf):
        entries = list(spec)
        per_dim = [_entry_axes(e) for e in entries]
        used = [a for axes in per_dim for a in axes]
        weight = float(np.prod(shape)) * 4.0 if shape else 0.0
        kw = dict(site=path or "<spec>", wasted_bytes=weight)
        dups = sorted({a for a in used if used.count(a) > 1})
        if dups:
            out.append(Finding(
                "pspec_dup_axis", "critical",
                f"PartitionSpec{tuple(entries)} uses mesh axis(es) {dups} "
                f"in more than one dim — an axis can shard only one dim",
                **kw))
        unknown = sorted({a for a in used if a not in axis_sizes})
        if unknown:
            out.append(Finding(
                "pspec_unknown_axis", "critical",
                f"PartitionSpec{tuple(entries)} names mesh axis(es) "
                f"{unknown} absent from the mesh "
                f"(have {sorted(axis_sizes)})", **kw))
            continue
        if not shape:
            continue
        for d, (dim, axes) in enumerate(zip(shape, per_dim)):
            prod = int(np.prod([axis_sizes[a] for a in axes])) if axes else 1
            if axes and prod and dim % prod:
                out.append(Finding(
                    "pspec_indivisible", "warn",
                    f"dim {d} (size {dim}) of PartitionSpec{tuple(entries)} "
                    f"is not divisible by its axis product {prod} "
                    f"({'x'.join(axes)}) — the rules fall back to "
                    f"replication", **kw))
        idle = [a for a, s in axis_sizes.items() if s > 1 and a not in used]
        if idle and len(shape) > len([a for a in per_dim if a]) - 1:
            big = max(range(len(shape)), key=lambda i: shape[i],
                      default=None)
            if big is not None and shape[big] >= big_dim \
                    and (big >= len(per_dim) or not per_dim[big]):
                out.append(Finding(
                    "pspec_unsharded_dim", "warn",
                    f"dominant dim {big} (size {shape[big]}) of "
                    f"PartitionSpec{tuple(entries)} is unsharded while mesh "
                    f"axis(es) {sorted(idle)} sit idle — shard it or accept "
                    f"the replicated memory/traffic", **kw))
    return _advise(out)
