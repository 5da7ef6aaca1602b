"""Collective capture of one sharded step: the port's replacement for the
reference's HLO parsing (`core/hlo_parser.py`) and its tracer
(`core/tracer.py`).

The reference compiles the step and reads the collectives out of XLA's HLO.
The port runs the step once, eagerly, on a `torch.distributed` DeviceMesh
and records each collective that the step actually dispatches:

  (1) run the step once under two modes:
      * a `TorchDispatchMode` that lets DTensor desugar its ops (it returns
        `NotImplemented` for DTensor arguments, as `CommDebugMode` does) and
        then sees the `_c10d_functional` collectives on the local shards,
        with their bytes (an op's input, but an all-gather's gathered
        output, as the reference's parser reads one and the cost model's
        (n-1)/n expects), dtype and process group ("recording UCT"), and the
        port's point-to-point op (`repro_torch::ppermute`,
        `distributed.ppermute`) as a `collective-permute` with its pairs;
      * a `TorchFunctionMode` that tags each autograd node with the scope
        path open when forward created it (`repro_torch.scope`), so that a
        collective in backward, which runs outside forward's scopes, is
        attributed to the scope of the node that issued it;
  (2) resolve each group onto the mesh (global ranks, and every group of
      that layout across the mesh: the replica groups);
  (3) fold identical sites (scope path, kind, groups, bytes, dtype, permute
      pairs) into `multiplicity`: the Python loop over layers and the
      micro-batch loop repeat each site;
  (4) build a `TraceStore`, price it (`costmodel.annotate_store`) and
      attribute it (`attribution.attribute_store`), as the reference's
      `tracer.trace_from_hlo` does.

Each event's `op_name` is written in the reference's form, so that the
copied `attribution` rules read it unchanged: `scope/.../op`, the scope path
from `repro_torch.scope` and `op` the c10d op's name
(`_c10d_functional.all_reduce`, which becomes `jax_prim`).  A backward
collective's `op_name` starts with `transpose(jvp)/`, the marker that
`attribution.is_backward` reads; a collective of a forward recomputed in
backward (remat) is a forward one, as in the reference.

`Trace.hlo_flops` is the rank's FLOP count of the step (forward, recompute
and backward), counted on the local shards by the table that
`torch.utils.flop_counter.FlopCounterMode` reads (the kernels' custom ops
are in it, each counted as that table counts its plain version).
Two counts of the bytes the rank's local ops move (views, allocations and
collectives move none):
  * `Trace.hlo_bytes_unfused`: every op's tensor inputs and outputs, as the
    eager step runs them, one op at a time: an upper bound on what a fused
    program moves;
  * `Trace.hlo_bytes` (and `op_stats.bytes_accessed`, `bytes_by_scope`),
    the counterpart of XLA's fused "bytes accessed", which the roofline's
    memory term reads: chains of pointwise ops (`torch.Tag.pointwise`, and
    dtype casts) are taken as fused regions.  A pointwise op's output is
    not written where it is made; it is written once, when it leaves its
    region: read by an op that is not pointwise (or a collective), or still
    live at the step's end.  One that dies inside its region is never
    written.  A pointwise op reads only the inputs that come from outside its
    region (tensors already written); every other op reads its inputs and
    writes its outputs, as in the unfused count (`_FusedBytes`).
`argument_bytes` is the local bytes of the step's tensor arguments;
`output_bytes` stays 0.  `per_device_memory_bytes` is the card's peak
allocation over a real step on the card (0 on the CPU), and over a step on
fake tensors (`FakeTensorMode`, the dry-run's) the rank's peak of live
storage bytes, the step's arguments included (`_LiveBytes`: each storage
counted from the op that made it until it is freed; `peak_holders`
names the storages live at that peak).  torch's
`MemTracker` reads the same peak, but asks each fake tensor for its device,
a dispatch of its own, and took ~40% of a fake step for it.

The step runs the same under `FakeTensorMode`: nothing is allocated and
the fake process group moves nothing, yet every collective, FLOP and byte
is recorded as in a real run.  DTensor infers an op's output layout by
running the op once on fake tensors of the global shape (on its first call
with that signature); those runs are hidden from the modes here
(`_dtensor_bookkeeping_unseen`), so that they count neither in a real run
nor in a fake one.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import scope as scope_mod
from repro_torch.core import attribution, costmodel
from repro_torch.core.events import CollectiveEvent, HloOpStats, Trace
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec

# `_c10d_functional` op name -> collective kind (the reference's HLO names)
KINDS: Dict[str, str] = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    # the port's point-to-point exchange (`distributed.ppermute`), with its pairs
    "ppermute": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
_PERMUTE = ("repro_torch", "ppermute")
BACKWARD_MARKER = "transpose(jvp)"


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


_DEVICE = torch.ops.prim.device.default
# allocations: no bytes read or written
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
# DTensor's own bookkeeping that runs tensor ops, under the names the torch
# version has: the sharding propagator's entry points, cached (the one an
# eager step calls, a per-propagator `LocalLRUCache`) and uncached, whose
# strategy choice may trace an op's decomposition on meta tensors
# (`DecompShardingStrategy`); its run of an op on fake tensors of the global
# shape, which other DTensor code also calls; and a strided shard's index
# arithmetic
_PROPAGATION = ("propagate_op_sharding", "propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _unseen(fn):
    """`fn` run with every dispatch mode popped."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _not_tracing() -> bool:
    return torch.compiler.is_compiling()


@contextmanager
def _dtensor_eager():
    """DTensor takes other paths when it thinks it is traced (a fake mode
    active: torch.compile's case, with symbolic shapes): uncached sharding
    propagation and redistribution plans, other placements for some views.
    A step on fake tensors has no symbolic shape, so here DTensor is told
    what a real step tells it, and both run the same code."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (_collective_utils, _decompositions, _dispatch,
                                          _redistribute)
    mods = [m for m in (funcol, _collective_utils, _decompositions, _dispatch, _redistribute)
            if hasattr(m, "_are_we_tracing")]
    saved = [m._are_we_tracing for m in mods]
    for m in mods:
        m._are_we_tracing = _not_tracing
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m._are_we_tracing = fn


@contextmanager
def _dtensor_bookkeeping_unseen():
    """Run DTensor's bookkeeping (`_PROPAGATION`, `_StridedShard`'s offsets) with
    every dispatch mode popped: in a step on fake tensors it would otherwise
    run in the step's own fake mode, where its index arithmetic cannot read
    values and where the recorder would count its global-shape ops (FLOPs,
    bytes, live bytes); in a real step it would count the same ops."""
    from torch.distributed.tensor.placement_types import _StridedShard
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _PROPAGATION if hasattr(prop, n)]
    if "propagate_op_sharding" not in names or not set(names) & set(_PROPAGATION[2:]):
        raise RuntimeError(f"DTensor's sharding propagator lacks propagate_op_sharding or "
                           f"all of {_PROPAGATION[2:]}")
    # the instance's own attributes (the cache is one), restored as they were;
    # a method is shadowed on the instance and the shadow then removed
    own = {n: prop.__dict__[n] for n in names if n in prop.__dict__}
    strided = _StridedShard.__dict__.get("local_shard_size_and_offset")
    for n in names:
        setattr(prop, n, _unseen(getattr(prop, n)))
    if strided is not None:
        _StridedShard.local_shard_size_and_offset = _unseen(strided)
    try:
        yield
    finally:
        for n in names:
            if n in own:
                setattr(prop, n, own[n])
            else:
                delattr(prop, n)
        if strided is not None:
            _StridedShard.local_shard_size_and_offset = strided


def _tag(node, names: Tuple[str, ...]) -> None:
    """Record `names` on `node` and on every untagged node behind it."""
    todo = [node]
    while todo:
        n = todo.pop()
        if n is None or scope_mod.NODE_KEY in n.metadata:
            continue
        n.metadata[scope_mod.NODE_KEY] = names
        todo.extend(f for f, _ in n.next_functions)


class _ScopeTagger(TorchFunctionMode):
    """Tags the autograd nodes forward creates with the open scope path."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            names = scope_mod.current()
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                    _tag(t.grad_fn, names)
        return out


class _LiveBytes:
    """The peak of live storage bytes over a step: each storage tracked is
    counted once (views share it) until Python frees it.  With `holders_at`
    (bytes) it also takes `holders`, the storages live when the live bytes
    first reach it, each as (op that made it, scope, shape, dtype, bytes)."""

    def __init__(self, tensors, holders_at: "float | None" = None):
        self.live = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self.holders_at, self.holders = holders_at, None
        self._made: "Dict[int, tuple] | None" = None if holders_at is None else {}
        for t in tensors:
            self.track(t)

    def track(self, t, func=None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _ref, key=key, n=n: self._free(key, n))
        self.live += n
        self.peak = max(self.peak, self.live)
        if self._made is not None:
            self._made[key] = (str(func) if func is not None else "argument",
                               "/".join(scope_mod.current()), tuple(t.shape), str(t.dtype), n)
            if self.holders is None and self.live >= self.holders_at:
                self.holders = [self._made[k] for k in self._refs]

    def _free(self, key: int, n: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n
            if self._made is not None:
                del self._made[key]


_HOLDER_REQUESTS: List[Tuple[float, list]] = []     # open `peak_holders` blocks


@contextmanager
def peak_holders(at: float):
    """What holds a fake step's memory: inside this block each step that
    `trace_step` runs on fake tensors takes the storages live when its live
    bytes first reach `at` bytes.  Yields a list that gets one entry per such
    step: those storages as (op that made each, scope, shape, dtype, bytes),
    or None if the step stayed below `at`.  Trace the step once for its peak
    (`Trace.per_device_memory_bytes`), then again in here with `at` = that
    peak."""
    request = (at, [])
    _HOLDER_REQUESTS.append(request)
    try:
        yield request[1]
    finally:
        _HOLDER_REQUESTS.remove(request)


# dtype casts: fused into their consumers, as XLA fuses converts
_FUSIBLE = {torch.ops.aten._to_copy}


def _pointwise(func) -> bool:
    return torch.Tag.pointwise in func.tags or func._overloadpacket in _FUSIBLE


class _FusedBytes:
    """The fused count (see the module's docstring).  `pending` holds the
    storages that pointwise ops made and nothing has written yet: {storage
    key: (bytes, scope)}, each dropped when Python frees its storage."""

    def __init__(self):
        self.bytes = 0
        self.by_scope: Dict[str, float] = defaultdict(float)
        self.pending: Dict[int, Tuple[int, str]] = {}
        self._refs: Dict[int, weakref.ref] = {}

    def _add(self, n: int, scope: str) -> None:
        self.bytes += n
        self.by_scope[scope] += n

    def _write_pending(self, key: int) -> None:
        n, scope = self.pending.pop(key)
        self._refs.pop(key, None)
        self._add(n, scope)

    def leave(self, tensors) -> None:
        """`tensors` read outside a region (a collective's operands)."""
        for t in tensors:
            key = t.untyped_storage()._cdata
            if key in self.pending:
                self._write_pending(key)

    def op(self, func, inputs, outputs, scope: str) -> None:
        pointwise = _pointwise(func)
        for t in inputs:
            key = t.untyped_storage()._cdata
            if key in self.pending:
                if pointwise:
                    continue              # inside the region: never read from memory
                self._write_pending(key)
            self._add(t.numel() * t.element_size(), scope)
        for t in outputs:
            n = t.numel() * t.element_size()
            if not pointwise:
                self._add(n, scope)
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.pending:
                self.pending[key] = (n, scope)
                self._refs[key] = weakref.ref(st, lambda _r, key=key: self._drop(key))

    def _drop(self, key: int) -> None:
        self.pending.pop(key, None)
        self._refs.pop(key, None)

    def finish(self) -> None:
        """Write what is still pending and live: the step's results."""
        for key in list(self.pending):
            self._write_pending(key)


class _Recorder(TorchDispatchMode):
    """Records each collective on local tensors and counts local FLOPs and
    bytes (unfused, and fused by `_FusedBytes`)."""

    def __init__(self, live: "_LiveBytes | None" = None):
        super().__init__()
        self.live = live
        self.calls: List[tuple] = []
        self.flops = 0
        self.bytes = 0
        self.fused = _FusedBytes()
        self.flops_by_scope: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE and isinstance(args[0], FakeTensor):
            return args[0].fake_device  # as FakeTensor answers it: the autograd
            # engine asks it of every gradient, the commonest op of a fake step
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor run, then see its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _NAMESPACES or (func.namespace, func._opname) == _PERMUTE:
            if func._opname in KINDS:
                self.calls.append(self._collective(func, args, kwargs, out))
                self.fused.leave(_tensors((args, kwargs)))
            return out
        written = _nbytes(out)        # 0 for a query (sizes, device) as for no output
        if written and not func.is_view and func._overloadpacket not in _ALLOCATIONS:
            self.bytes += _nbytes((args, kwargs)) + written
            self.fused.op(func, _tensors((args, kwargs)), _tensors(out),
                          "/".join(scope_mod.current()))
        if written and self.live is not None:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.live.track(t, func)
        if func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_scope["/".join(scope_mod.current())] += f
        return out

    @staticmethod
    def _collective(func, args, kwargs, out) -> tuple:
        names = scope_mod.current()
        node = torch._C._current_autograd_node()
        # in backward with no scope open on this thread: a backward node's own
        # collective (scopes open in backward belong to a remat recompute)
        backward = node is not None and not names
        if backward:
            names = node.metadata.get(scope_mod.NODE_KEY, ())
        group = kwargs.get("group_name", args[-1])
        tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        # a permute's (source, target) pairs, ranks of its group
        pairs = tuple(zip(args[1], args[2])) if func.namespace == _PERMUTE[0] else None
        # an all-gather's payload is the gathered tensor, as the reference's HLO
        # parser reads it and the cost model's (n-1)/n expects; every other
        # kind's is its input (a reduce-scatter's the pre-scatter tensor)
        payload = out if KINDS[func._opname] == "all-gather" else args
        return (func._opname, f"{func.namespace}.{func._opname}", names, backward, group,
                _nbytes(payload), _nbytes(out), str(tensors[0].dtype).replace("torch.", ""),
                pairs)


def replica_groups(ranks: Sequence[int], mesh_ranks: np.ndarray) -> List[List[int]]:
    """Every group of the layout `ranks` belongs to: the mesh's ranks split
    along the mesh dims that vary inside `ranks` (row-major within a group)."""
    coords = np.argwhere(np.isin(mesh_ranks, list(ranks)))
    varying = [d for d in range(mesh_ranks.ndim) if len(np.unique(coords[:, d])) > 1]
    if not varying:
        return [[int(r)] for r in mesh_ranks.reshape(-1)]
    fixed = [d for d in range(mesh_ranks.ndim) if d not in varying]
    size = int(np.prod([mesh_ranks.shape[d] for d in varying]))
    return mesh_ranks.transpose(fixed + varying).reshape(-1, size).tolist()


def _op_name(names: Tuple[str, ...], prim: str, backward: bool) -> str:
    path = "/".join(names + (prim,))
    return f"{BACKWARD_MARKER}/{path}" if backward else path


def _events(calls, mesh, label: str) -> List[CollectiveEvent]:
    """Fold the recorded calls into sites, first-seen order.

    A permute is written as the reference's HLO parser reads one: its pairs
    on global ranks, repeated in every group of its layout (the whole mesh's
    table), and one replica group of every mesh rank."""
    mesh_ranks = mesh.mesh.cpu().numpy()
    every_rank = [sorted(int(r) for r in mesh_ranks.reshape(-1))]
    groups_of: Dict[str, tuple] = {}
    sites: Dict[tuple, CollectiveEvent] = {}
    for opname, prim, names, backward, group, ob, rb, dtype, pairs in calls:
        if group not in groups_of:
            pg = dist.distributed_c10d._resolve_process_group(group)
            ranks = dist.get_process_group_ranks(pg)
            groups_of[group] = (ranks, replica_groups(ranks, mesh_ranks))
        ranks, groups = groups_of[group]
        stp = None
        if pairs is not None:
            # group rank i is the i-th rank of each group (row-major, as a mesh dim's)
            if ranks not in groups:
                raise ValueError(f"permute group {ranks} is not a row-major group of the mesh")
            stp = [(g[s], g[t]) for g in groups for s, t in pairs]
            groups = every_rank
        op_name = _op_name(names, prim, backward)
        kind = KINDS[opname]
        key = (op_name, kind, group, ob, rb, dtype, pairs)
        ev = sites.get(key)
        if ev is None:
            sites[key] = CollectiveEvent(
                name=f"%{kind}.{len(sites)}", kind=kind, async_start=False,
                operand_bytes=ob, result_bytes=rb, dtype=dtype,
                replica_groups=groups, group_size=len(groups[0]), num_groups=len(groups),
                op_name=op_name, computation=label, source_target_pairs=stp)
        else:
            ev.multiplicity += 1
    return list(sites.values())


def trace_step(fn: Callable, args, mesh, mesh_spec: MeshSpec, *, label: str = "step",
               hw: Hardware = H100) -> Trace:
    """Run `fn(*args)` once on `mesh` (a DeviceMesh) and return the `Trace` of
    the collectives it dispatched, priced on `mesh_spec` by `hw`.

    The caller opens `distributed.autoshard.activation_sharding(mesh)` around
    the call as it would around the step, and `FakeTensorMode` around both
    when `args` are fake.  `fn` runs for real: a train step updates its
    params and moments in place, as any step does.
    """
    local = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(args)
             if isinstance(t, torch.Tensor)]
    fake = any(isinstance(t, FakeTensor) for t in local)
    request = _HOLDER_REQUESTS[-1] if _HOLDER_REQUESTS and fake else None
    live = _LiveBytes(local, holders_at=request[0] if request else None) if fake else None
    recorder, tagger = _Recorder(live), _ScopeTagger()
    on_card = mesh.device_type == "cuda" and not fake
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with _dtensor_eager(), _dtensor_bookkeeping_unseen(), tagger, recorder:
        result = fn(*args)
    recorder.fused.finish()           # while the step's results are live
    del result
    peak = (torch.cuda.max_memory_allocated() if on_card
            else recorder.live.peak if fake else 0)
    if request:
        request[1].append(recorder.live.holders)
    with unset_fake_temporarily():
        return _trace(recorder, mesh, mesh_spec, label, hw, local, peak)


def _trace(recorder, mesh, mesh_spec, label, hw, local, peak) -> Trace:
    events = _events(recorder.calls, mesh, label)
    store = TraceStore.from_events(events)
    costmodel.annotate_store(store, mesh_spec, hw)
    attribution.attribute_store(store)
    stats = HloOpStats(flops=float(recorder.flops), bytes_accessed=float(recorder.fused.bytes),
                       flops_by_scope=dict(recorder.flops_by_scope),
                       bytes_by_scope=dict(recorder.fused.by_scope))
    trace = Trace.from_store(label, mesh_spec.shape, mesh_spec.axes, mesh_spec.num_devices,
                             store, op_stats=stats, hlo_flops=float(recorder.flops),
                             hlo_bytes=float(recorder.fused.bytes),
                             per_device_memory_bytes=float(peak),
                             argument_bytes=float(_nbytes(local)))
    trace.hlo_bytes_unfused = float(recorder.bytes)
    return trace
