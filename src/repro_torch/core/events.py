"""Event model for the multi-layer trace (the ucTrace data model), a copy
of the reference's `core/events.py` with its field names kept.

Layer mapping in the port (see DESIGN.md §2):
  MPI  function   -> `semantic`   (grad_sync / attention / moe_dispatch / ...)
  UCP  operation  -> `jax_prim`   (in the port: the aten/c10d op that the
                                   step dispatched, e.g.
                                   `_c10d_functional.all_reduce`)
  UCT  send       -> `CollectiveEvent` (one collective site the captured
                                   step dispatched, `core/capture.py`)
  UCT  transport  -> `link_class` (nvlink.<axis> / ib.<axis> / mixed / local)
  completion time -> `est_time_s` (cost model)

`name`, `computation` and `op_name` keep their reference names: the capture
writes a site label, the step's label, and `scope/.../op` paths in the
reference's `op_name` form (see `core/capture.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class CollectiveEvent:
    """One HLO collective op instance (the UCT-layer record)."""

    name: str                      # HLO op name (%all-reduce.1)
    kind: str                      # all-reduce | all-gather | reduce-scatter |
                                   # all-to-all | collective-permute
    async_start: bool              # -start form (overlappable)
    operand_bytes: int             # sum of operand payload bytes
    result_bytes: int
    dtype: str
    replica_groups: List[List[int]]    # resolved device ids per group
    group_size: int
    num_groups: int
    op_name: str                   # HLO metadata op_name (call-stack analogue)
    computation: str               # enclosing HLO computation
    multiplicity: int = 1          # executions per step (while-loop trip counts)
    channel_id: Optional[int] = None
    source_target_pairs: Optional[List[Tuple[int, int]]] = None  # permutes

    # derived (filled by attribution/topology/cost model)
    link_class: str = ""           # nvlink.<axis> | ib.<axis> | *.mixed(..) | local
    axes: Tuple[str, ...] = ()     # mesh axes the groups span
    semantic: str = ""             # MPI-function analogue
    jax_prim: str = ""             # UCP-operation analogue
    scope: str = ""                # named_scope path prefix
    protocol: str = ""             # eager | rndv  (latency- vs bandwidth-bound)
    wire_bytes_per_device: float = 0.0
    est_time_s: float = 0.0

    @property
    def total_wire_bytes(self) -> float:
        """Wire traffic summed over participating devices, per execution."""
        return self.wire_bytes_per_device * self.group_size * self.num_groups


def site_key(e: "CollectiveEvent") -> str:
    """Site-level alignment key: op_name x kind x mesh axes.

    The per-event analogue of the interned code triple the columnar diff
    aligns on (`TraceStore._codes_for("site")`) — one key per compiled
    callsite class, so cross-run regressions localize to the op_name that
    produced them instead of washing out in kind x link rollups.
    """
    return f"{e.op_name}|{e.kind}|{','.join(e.axes)}"


@dataclass
class HloOpStats:
    """Non-collective per-program stats used by detectors/roofline."""

    n_transpose: int = 0
    n_fusion: int = 0
    n_convert: int = 0
    n_reshape: int = 0
    transpose_bytes: int = 0
    # loop-aware totals (x while trip counts) — cost_analysis counts loop
    # bodies once, so these are the authoritative roofline inputs.
    flops: float = 0.0
    bytes_accessed: float = 0.0
    # per-named_scope attribution (module-level rollups + kernel-adjusted
    # rooflines: e.g. subtract `attn` score traffic when the Pallas flash
    # kernel replaces the XLA blocked path)
    bytes_by_scope: Dict[str, float] = field(default_factory=dict)
    flops_by_scope: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def merged(cls, parts: List["HloOpStats"]) -> "HloOpStats":
        """Combine per-shard stats (sharded ingest; see hlo_parser).

        Every contribution is an integer-valued float (byte/FLOP counts x
        integer multiplicities), so the partial-sum reassociation is exact
        below 2^53 and the merge equals a serial accumulation.  Scope dicts
        keep first-seen order across shards — the serial insertion order.
        """
        out = cls()
        for p in parts:
            out.n_transpose += p.n_transpose
            out.n_fusion += p.n_fusion
            out.n_convert += p.n_convert
            out.n_reshape += p.n_reshape
            out.transpose_bytes += p.transpose_bytes
            out.flops += p.flops
            out.bytes_accessed += p.bytes_accessed
            for k, v in p.bytes_by_scope.items():
                out.bytes_by_scope[k] = out.bytes_by_scope.get(k, 0.0) + v
            for k, v in p.flops_by_scope.items():
                out.flops_by_scope[k] = out.flops_by_scope.get(k, 0.0) + v
        return out


class Trace:
    """A complete multi-layer communication trace of one compiled step.

    The trace is columnar end to end: the default ingest path
    (`tracer.trace_from_hlo(engine="columnar")`) parses straight into a
    `TraceStore` (see store.py) and this class is built `from_store`, with
    `events` as a lazily-materialized row view — exactly like a trace
    loaded from a saved store.  Named rollups and totals are `np.bincount`
    over interned codes, not Python loops.

    Events can still be *supplied* as a list of `CollectiveEvent` (the
    per-event reference pipeline and hand-built test traces); the store is
    then built lazily from the rows.  Staleness detection is by length
    only: reassigning `events` or changing the list's length invalidates
    the store automatically; any same-length mutation (replacing a list
    item, editing an event's fields in place) after an aggregate was
    computed requires an explicit `invalidate()`.
    """

    # set by a salvage read of a capture dump
    # (`dump.trace_from_capture(recover=True)`): the `dump.SalvageReport`
    # describing what the damaged capture lost, None for a strict read
    salvage = None

    def __init__(self, label: str, mesh_shape: Tuple[int, ...],
                 mesh_axes: Tuple[str, ...], num_devices: int,
                 events: Optional[List[CollectiveEvent]] = None,
                 op_stats: Optional[HloOpStats] = None, *,
                 store=None,
                 hlo_flops: float = 0.0, hlo_bytes: float = 0.0,
                 per_device_memory_bytes: float = 0.0,
                 argument_bytes: float = 0.0, output_bytes: float = 0.0):
        self.label = label
        self.mesh_shape = tuple(mesh_shape)
        self.mesh_axes = tuple(mesh_axes)
        self.num_devices = num_devices
        self.op_stats = op_stats if op_stats is not None else HloOpStats()
        # compiled-artifact numbers (cost_analysis / memory_analysis)
        self.hlo_flops = hlo_flops
        self.hlo_bytes = hlo_bytes
        # the port's capture also counts its eager ops' bytes unfused
        # (`core.capture`); not saved with the trace
        self.hlo_bytes_unfused = hlo_bytes
        self.per_device_memory_bytes = per_device_memory_bytes
        self.argument_bytes = argument_bytes
        self.output_bytes = output_bytes
        if store is not None and events is None:
            self._events: Optional[List[CollectiveEvent]] = None
        else:
            self._events = list(events) if events is not None else []
        self._store = store

    def __repr__(self) -> str:
        return (f"Trace(label={self.label!r}, mesh_shape={self.mesh_shape}, "
                f"mesh_axes={self.mesh_axes}, sites={self.sites})")

    @property
    def sites(self) -> int:
        """Number of collective op sites (without materializing rows)."""
        return len(self._events) if self._events is not None else self._store.n

    # ---- columnar backing --------------------------------------------------

    @property
    def events(self) -> List[CollectiveEvent]:
        if self._events is None:          # loaded from a store: rows on demand
            self._events = self._store.rows()
        return self._events

    @events.setter
    def events(self, value: List[CollectiveEvent]) -> None:
        self._events = list(value)
        self._store = None

    @property
    def store(self):
        """The columnar view; (re)built when the event list changed length."""
        from repro_torch.core.store import TraceStore
        if self._store is None or (self._events is not None
                                   and self._store.n != len(self._events)):
            self._store = TraceStore.from_events(self._events or [])
        return self._store

    def invalidate(self) -> None:
        """Drop the cached columns after a same-length event mutation
        (item replacement or in-place field edit) — length changes are
        detected automatically, these are not."""
        if self._events is None:
            self._events = self._store.rows()
        self._store = None

    @classmethod
    def from_store(cls, label: str, mesh_shape: Tuple[int, ...],
                   mesh_axes: Tuple[str, ...], num_devices: int, store,
                   **kw) -> "Trace":
        return cls(label, mesh_shape, mesh_axes, num_devices, store=store, **kw)

    # ---- aggregate views (vectorized over the store) -----------------------
    def total_collective_bytes(self) -> float:
        """Sum of operand sizes x multiplicity (roofline definition)."""
        return self.store.total_collective_bytes()

    def total_wire_bytes(self) -> float:
        return self.store.total_wire_bytes()

    def total_est_time_s(self) -> float:
        return self.store.total_est_time_s()

    def overlapped_est_time_s(self) -> float:
        """Lower bound on collective time with perfect cross-link overlap.

        Different link classes (nvlink.model vs ib.data) use
        disjoint physical links, so a latency-hiding scheduler can run them
        concurrently: the bound is the max per-class serialized time, not
        the sum.  Together with total_est_time_s() this brackets reality.
        """
        return self.store.overlapped_est_time_s()

    def by(self, key_fn) -> Dict[str, Dict[str, float]]:
        """Aggregate {key: {bytes, wire_bytes, count, time_s}}.

        Reference per-event path for *arbitrary* key functions (and the
        baseline the columnar rollups are equivalence-tested against).
        The named rollups below run columnar instead.
        """
        agg: Dict[str, Dict[str, float]] = {}
        for e in self.events:
            k = key_fn(e)
            a = agg.setdefault(k, {"bytes": 0.0, "wire_bytes": 0.0,
                                   "count": 0.0, "time_s": 0.0})
            a["bytes"] += e.operand_bytes * e.multiplicity
            a["wire_bytes"] += e.total_wire_bytes * e.multiplicity
            a["count"] += e.multiplicity
            a["time_s"] += e.est_time_s * e.multiplicity
        return agg

    def by_kind_and_link(self):
        return self.store.by_kind_and_link()

    def by_semantic(self):
        return self.store.by_semantic()

    def by_site(self):
        """Per-callsite rollup keyed on `site_key` (op_name x kind x axes)."""
        return self.store.by_site()
