"""Mesh topology model for H100 nodes: replica groups -> mesh axes -> link
classes (a copy of the reference's `core/topology.py` with an H100 hardware
model in place of the TPU v5e's).

This is the `UCT transport` resolution layer: where ucTrace maps a UCT send
to a transport (`cuda_ipc` for peers in one node, `rc_mlx5` across nodes)
and a NIC, the port maps a collective's replica groups onto the device mesh
and classifies which interconnect the traffic rides: NVLink through the
node's NVSwitch, or InfiniBand between nodes.

Axis kinds are `nvlink` and `ib`; link classes read `nvlink.<axis>`,
`ib.<axis>`, `nvlink.mixed(a+b)`, `ib.mixed(a+b)`, `xnode.mixed(a+b)` (a
group that crosses both) and `local`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Hardware:
    """NVIDIA H100 SXM constants (per GPU / per link direction).

    Data-sheet values (NVIDIA H100 Tensor Core GPU data sheet, SXM5 column,
    dense rates): 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB; NVLink 4 at
    900 GB/s per GPU in both directions together (18 links x 25 GB/s each
    way), i.e. 450 GB/s each way through the node's NVSwitch.  InfiniBand:
    one ConnectX-7 NDR port per GPU (DGX H100 user guide), 400 Gb/s = 50 GB/s
    each way.

    No data sheet gives a per-step latency.  `nvlink_latency_s` (1 us) and
    `ib_latency_s` (5 us) are assumptions of this model: the order of one
    small-message ring step inside a node and across an InfiniBand switch.
    They were not measured by this repository.
    """

    name: str = "h100-sxm"
    flops_bf16: float = 989e12          # peak dense bf16 FLOP/s per GPU
    hbm_bw: float = 3.35e12             # HBM bytes/s per GPU
    nvlink_bw: float = 450e9            # NVLink bytes/s per GPU, each direction
    ib_bw: float = 50e9                 # InfiniBand NDR bytes/s per GPU, each direction
    nvlink_latency_s: float = 1e-6      # per ring step, assumed (see above)
    ib_latency_s: float = 5e-6          # per ring step, assumed (see above)
    hbm_per_chip: float = 80e9          # HBM capacity
    # directions a ring's bandwidth term can use.  Through NVSwitch and over
    # one NIC a ring sends each byte once on one direction (the reference's
    # torus ring runs both directions of a link: 2 there).
    ring_directions: int = 1
    # eager/rendezvous analogue: below this per-shard payload a transfer is
    # latency-dominated ("eager"), above it bandwidth-dominated ("rndv");
    # the reference's boundary, kept so the regime split is comparable.
    rndv_threshold: int = 1 << 16


H100 = Hardware()

# GPUs behind one NVSwitch (a DGX/HGX H100 node)
GPUS_PER_NODE = 8


def _default_axis_kind(shape: Sequence[int], axes: Sequence[str]) -> Dict[str, str]:
    """Row-major device ids fill a node first: the innermost axes whose sizes
    multiply to at most `GPUS_PER_NODE` stay in one node (NVLink); an axis
    that spans nodes, and `pod`, ride InfiniBand."""
    kind, inner = {}, 1
    for size, name in reversed(list(zip(shape, axes))):
        inner *= int(size)
        kind[name] = "nvlink" if inner <= GPUS_PER_NODE and name != "pod" else "ib"
    return {a: kind[a] for a in axes}


@dataclass(frozen=True)
class MeshSpec:
    """Logical device mesh + interconnect class per axis."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    # axis name -> "nvlink" | "ib"; default from the shape (`_default_axis_kind`)
    axis_kind: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes)
        if not self.axis_kind:
            object.__setattr__(self, "axis_kind",
                               _default_axis_kind(self.shape, self.axes))

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, device_id: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(device_id, self.shape))

    def coords_array(self, device_ids: Sequence[int]) -> np.ndarray:
        return np.stack(np.unravel_index(np.asarray(device_ids), self.shape),
                        axis=-1)

    @classmethod
    def single_pod(cls) -> "MeshSpec":
        """32 DGX H100 nodes: `model` is one node's 8 GPUs on NVLink, `data`
        runs across nodes on InfiniBand (256 GPUs, the reference pod's count)."""
        return cls((32, 8), ("data", "model"))

    @classmethod
    def multi_pod(cls) -> "MeshSpec":
        """Two such 256-GPU clusters joined by a `pod` axis on InfiniBand."""
        return cls((2, 32, 8), ("pod", "data", "model"))


def varying_axes(mesh: MeshSpec, group: Sequence[int]) -> Tuple[str, ...]:
    """Which mesh axes vary across the devices of one replica group."""
    if len(group) <= 1:
        return ()
    coords = mesh.coords_array(group)
    out = []
    for i, name in enumerate(mesh.axes):
        if len(np.unique(coords[:, i])) > 1:
            out.append(name)
    return tuple(out)


def link_class(mesh: MeshSpec, axes: Tuple[str, ...]) -> str:
    """Transport-class label for a collective spanning `axes`."""
    if not axes:
        return "local"
    if len(axes) == 1:
        a = axes[0]
        return f"{mesh.axis_kind[a]}.{a}"
    kinds = {mesh.axis_kind[a] for a in axes}
    label = "+".join(axes)
    if len(kinds) == 1:
        return f"{kinds.pop()}.mixed({label})"
    return f"xnode.mixed({label})"  # crosses both NVLink and InfiniBand


def slowest_link_bw(mesh: MeshSpec, axes: Tuple[str, ...], hw: Hardware) -> float:
    """Bottleneck link bandwidth for traffic spanning `axes`."""
    if not axes:
        return hw.hbm_bw
    bws = [hw.ib_bw if mesh.axis_kind[a] == "ib" else hw.nvlink_bw for a in axes]
    return min(bws)


def hop_latency(mesh: MeshSpec, axes: Tuple[str, ...], hw: Hardware) -> float:
    """Latency of one ring step for traffic spanning `axes`.

    The reference counts torus hops.  NVSwitch is one hop between any two
    GPUs of a node, and a fat-tree IB fabric a fixed switch path between
    nodes, so one step costs the slowest axis's latency whatever the two
    ranks' mesh distance; the step count is the algorithm's
    (`costmodel._latency_hops`)."""
    if not axes:
        return 0.0
    return max(hw.ib_latency_s if mesh.axis_kind[a] == "ib" else hw.nvlink_latency_s
               for a in axes)


@lru_cache(maxsize=4096)
def _resolve_iota_cached(num_groups: int, group_size: int,
                         reshape_dims: Tuple[int, ...],
                         transpose_perm: Optional[Tuple[int, ...]]
                         ) -> Tuple[Tuple[int, ...], ...]:
    n = int(np.prod(reshape_dims))
    ids = np.arange(n).reshape(reshape_dims)
    if transpose_perm is not None:
        ids = ids.transpose(transpose_perm)
    ids = ids.reshape(num_groups, group_size)
    return tuple(tuple(map(int, row)) for row in ids)


def resolve_iota_groups(num_groups: int, group_size: int,
                        reshape_dims: Sequence[int],
                        transpose_perm: Optional[Sequence[int]]) -> List[List[int]]:
    """Decode HLO iota replica groups `[G,S]<=[dims]T(perm)`.

    Memoized on the raw attribute tuple: unrolled loops stamp the same
    `replica_groups=[G,S]<=[dims]` attr onto thousands of ops, so the
    numpy decode runs once per unique attr; only the (cheap) list
    materialization happens per call, keeping results mutation-safe.

    Raises `ValueError` on a malformed attr (G*S != prod(dims), or a
    transpose perm that is not a permutation of the dims) instead of an
    opaque numpy reshape/transpose error — parser callers catch it and
    fall back to a full-range group.
    """
    dims = tuple(int(d) for d in reshape_dims)
    n = int(np.prod(dims)) if dims else 0
    if int(num_groups) * int(group_size) != n:
        raise ValueError(
            f"iota replica_groups [{num_groups},{group_size}]<={list(dims)}: "
            f"{num_groups}*{group_size} != prod(dims) = {n}")
    if transpose_perm is not None \
            and sorted(int(p) for p in transpose_perm) != list(range(len(dims))):
        raise ValueError(
            f"iota replica_groups transpose T({list(transpose_perm)}) is not "
            f"a permutation of {len(dims)} dims")
    rows = _resolve_iota_cached(
        int(num_groups), int(group_size), tuple(int(d) for d in reshape_dims),
        None if transpose_perm is None else tuple(int(p) for p in transpose_perm))
    return [list(r) for r in rows]


def comm_matrix(mesh: MeshSpec, events, resolution: str = "device") -> np.ndarray:
    """Device x device wire-byte matrix (ring-model neighbor traffic).

    The paper's Fig 3b analogue.  Ring collectives put traffic on ring
    neighbors within each replica group; permutes follow their explicit
    source->target pairs.

    `events` may be a `Trace`, a `TraceStore`, or a plain event iterable.
    The first two scatter a precomputed (src, dst, bytes) edge list with
    one `np.add.at` call instead of walking Python objects.
    """
    n = mesh.num_devices
    mat = np.zeros((n, n))
    store = getattr(events, "store", None)     # Trace -> its columnar store
    if store is None and hasattr(events, "ring_edges"):
        store = events                         # already a TraceStore
    if store is not None:
        src, dst, w = store.ring_edges()
        np.add.at(mat, (src, dst), w)
        return mat
    for e in events:
        mult = e.multiplicity
        if e.source_target_pairs:
            per = e.operand_bytes
            for s, t in e.source_target_pairs:
                mat[s, t] += per * mult
            continue
        for group in e.replica_groups:
            g = len(group)
            if g <= 1:
                continue
            per_link = e.wire_bytes_per_device * mult
            for i, d in enumerate(group):
                nxt = group[(i + 1) % g]
                mat[d, nxt] += per_link
    return mat


def reduce_matrix(mat: np.ndarray, mesh: MeshSpec, axis: str) -> np.ndarray:
    """Aggregate the device matrix to groups along one axis (viz)."""
    ai = mesh.axes.index(axis)
    k = mesh.shape[ai]
    n = mat.shape[0]
    labels = np.unravel_index(np.arange(n), mesh.shape)[ai]
    out = np.zeros((k, k))
    np.add.at(out, (labels[:, None], labels[None, :]), mat)
    return out
