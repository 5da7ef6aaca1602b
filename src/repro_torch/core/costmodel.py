"""Analytic completion model — the `completion tracking` analogue (a copy of
the reference's `core/costmodel.py`, priced by the port's H100 topology).

ucTrace wraps UCT completion callbacks to time each transfer.  Without
hardware we *model* completion: ring formulas per collective kind,
with a per-step latency term and a bandwidth term over the bottleneck link
class (NVLink or InfiniBand).  A measured per-collective time from the
card's profiler would fill the same column (isolated here so nothing else
changes).

The model also classifies each transfer into the paper's eager/rendezvous
analogue: below `hw.rndv_threshold` the latency term dominates ("eager");
above it the bandwidth term does ("rndv").
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.core.events import CollectiveEvent
from repro_torch.core.topology import (Hardware, MeshSpec, hop_latency, link_class,
                                 slowest_link_bw, varying_axes)


def wire_bytes_per_device(kind: str, operand_bytes: int, group_size: int) -> float:
    """Ring-algorithm wire bytes each participant sends, per execution."""
    n = max(group_size, 1)
    if n == 1:
        return 0.0
    per_shard = operand_bytes / n
    if kind == "all-reduce":
        # reduce-scatter + all-gather: 2 (n-1)/n x payload
        return 2.0 * (n - 1) * per_shard
    if kind in ("all-gather", "reduce-scatter"):
        return (n - 1) * per_shard
    if kind in ("all-to-all", "ragged-all-to-all"):
        # each device keeps 1/n of its per-device operand, sends the rest
        return operand_bytes * (n - 1) / n
    if kind == "collective-broadcast":
        return operand_bytes
    if kind == "collective-permute":
        return operand_bytes
    return operand_bytes


def _latency_hops(kind: str, group_size: int) -> int:
    """Ring steps of one execution (each a switch traversal on NVSwitch)."""
    n = max(group_size, 1)
    if n == 1:
        return 0
    if kind in ("all-reduce",):
        return 2 * (n - 1)          # ring RS+AG phases
    if kind in ("all-gather", "reduce-scatter"):
        return n - 1
    if kind in ("all-to-all", "ragged-all-to-all"):
        return n - 1
    return 1                        # permute / broadcast


def estimate_time_s(ev: CollectiveEvent, mesh: MeshSpec, hw: Hardware) -> float:
    """Modeled completion time of one execution of the collective."""
    bw = slowest_link_bw(mesh, ev.axes, hw)
    lat = hop_latency(mesh, ev.axes, hw)
    # directions the ring's bytes can use (1 through NVSwitch and one NIC)
    eff_bw = hw.ring_directions * bw
    t_bw = ev.wire_bytes_per_device / eff_bw if eff_bw else 0.0
    t_lat = _latency_hops(ev.kind, ev.group_size) * lat
    return t_lat + t_bw


def protocol_regime(ev: CollectiveEvent, hw: Hardware) -> str:
    """eager/rendezvous analogue: latency- vs bandwidth-dominated."""
    per_shard = ev.operand_bytes / max(ev.group_size, 1)
    return "eager" if per_shard < hw.rndv_threshold else "rndv"


def annotate_event(ev: CollectiveEvent, mesh: MeshSpec, hw: Hardware) -> None:
    """Fill topology + completion fields in place."""
    groups = ev.replica_groups
    rep = groups[0] if groups else []
    ev.axes = varying_axes(mesh, rep)
    if ev.source_target_pairs:
        # permutes: classify from an example pair
        s, t = ev.source_target_pairs[0]
        ev.axes = varying_axes(mesh, [s, t])
    ev.link_class = link_class(mesh, ev.axes)
    ev.wire_bytes_per_device = wire_bytes_per_device(
        ev.kind, ev.operand_bytes, ev.group_size)
    ev.protocol = protocol_regime(ev, hw)
    ev.est_time_s = estimate_time_s(ev, mesh, hw)


# --------------------------------------------------------------------------
# batched path: one vectorized pass over TraceStore columns
# --------------------------------------------------------------------------

def annotate_store(store, mesh: MeshSpec, hw: Hardware) -> None:
    """Columnar `annotate_event`: fill topology + completion columns in place.

    Topology resolution (`varying_axes`, `link_class`, link bw/latency) runs
    once per *unique* replica-group / permute table and broadcasts through
    the store's int32 codes; wire bytes, latency hops, protocol regime, and
    `est_time_s` are vectorized numpy expressions branching on the interned
    `kind` codes via masks.  Field-for-field (bit-for-bit on the float
    columns) equivalent to running `annotate_event` over `store.rows()` —
    pinned by tests/test_ingest.py.

    Contract: annotation *rebinds, never mutates*.  Derived columns
    (`link_class`, `protocol`, `wire_bytes_per_dev`, `est_time_s`, axes)
    are assigned as fresh arrays/Categoricals; the input columns they are
    computed from are only read.  `repro_torch.core.whatif` relies on this to
    re-annotate a `TraceStore.annotation_clone()` (which shares row data
    by reference) under counterfactual meshes/hardware without touching
    the baseline store.
    """
    from repro_torch.core.store import Categorical, build_remap

    n = store.n
    if n == 0:
        store.link_class = Categorical.constant(0)
        store.protocol = Categorical.constant(0)
        return

    # ---- axes: once per unique group table (permute pairs override) -------
    ax_index = {}
    axes_tables = []

    def _ax_code(t: Tuple[str, ...]) -> int:
        c = ax_index.get(t)
        if c is None:
            c = ax_index[t] = len(axes_tables)
            axes_tables.append(t)
        return c

    g_codes = np.fromiter(
        (_ax_code(varying_axes(mesh, groups[0] if groups else []))
         for groups in store.group_tables),
        dtype=np.int32, count=len(store.group_tables))
    axes_code = (g_codes[store.group_code] if len(g_codes)
                 else np.zeros(n, dtype=np.int32))
    stp_mask = store.stp_code >= 0
    if stp_mask.any():
        s_codes = np.fromiter(
            (_ax_code(varying_axes(mesh, [pairs[0][0], pairs[0][1]]))
             for pairs in store.stp_tables),
            dtype=np.int32, count=len(store.stp_tables))
        axes_code[stp_mask] = s_codes[store.stp_code[stp_mask]]
    store.set_axes(axes_tables, axes_code)

    # ---- per-axes-class scalars, broadcast per row ------------------------
    lc_map, lc_vocab = build_remap([link_class(mesh, t) for t in axes_tables])
    store.link_class = Categorical(lc_map[axes_code], lc_vocab)

    bw = np.array([slowest_link_bw(mesh, t, hw) for t in axes_tables],
                  dtype=np.float64)[axes_code]
    lat = np.array([hop_latency(mesh, t, hw) for t in axes_tables],
                   dtype=np.float64)[axes_code]

    # ---- wire bytes + latency hops: masks over interned kind codes -------
    kc = store.kind.codes
    ob = store.operand_bytes
    nn = np.maximum(store.group_size, 1)
    per_shard = ob / nn
    wire = ob.astype(np.float64)                  # permute/broadcast/default
    hops = np.ones(n, dtype=np.int64)
    for code, kind in enumerate(store.kind.vocab):
        mask = kc == code
        if not mask.any():
            continue
        if kind == "all-reduce":
            wire[mask] = (2.0 * (nn[mask] - 1)) * per_shard[mask]
            hops[mask] = 2 * (nn[mask] - 1)
        elif kind in ("all-gather", "reduce-scatter"):
            wire[mask] = (nn[mask] - 1) * per_shard[mask]
            hops[mask] = nn[mask] - 1
        elif kind in ("all-to-all", "ragged-all-to-all"):
            wire[mask] = ob[mask] * (nn[mask] - 1) / nn[mask]
            hops[mask] = nn[mask] - 1
    single = nn == 1
    wire[single] = 0.0
    hops[single] = 0
    store.wire_bytes_per_device = wire

    # ---- protocol regime + completion time --------------------------------
    eager = per_shard < hw.rndv_threshold
    proto_codes = np.where(eager, np.int32(0), np.int32(1))
    store.protocol = Categorical(proto_codes, ["eager", "rndv"])

    eff_bw = hw.ring_directions * bw
    t_bw = np.divide(wire, eff_bw, out=np.zeros(n, dtype=np.float64),
                     where=eff_bw != 0.0)
    store.est_time_s = hops * lat + t_bw


# --------------------------------------------------------------------------
# explicit algorithm models (Fig 5 analogue: ring / RSAG / recursive doubling)
# --------------------------------------------------------------------------

def allreduce_time(algorithm: str, payload_bytes: int, group_size: int,
                   link_bw: float, lat: float, hw: Hardware) -> float:
    """Closed-form Allreduce cost for the three classic algorithms, over
    `hw.ring_directions` directions of each link, as the per-event model
    prices them: 2 (n-1) hops of b/n, or log2 n hops of b, priced by
    `annotate_store`, sum to these forms."""
    n = max(group_size, 2)
    b = payload_bytes
    bw = hw.ring_directions * link_bw
    if algorithm == "ring":
        return 2 * (n - 1) * lat + 2 * (n - 1) / n * b / bw
    if algorithm == "reduce_scatter_allgather":
        # same traffic as ring but log-structured latency on a torus
        steps = 2 * math.ceil(math.log2(n))
        return steps * lat + 2 * (n - 1) / n * b / bw
    if algorithm == "recursive_doubling":
        steps = math.ceil(math.log2(n))
        return steps * lat + steps * b / bw
    raise ValueError(algorithm)
