"""Named scopes, spans and step records: the port's `jax.named_scope`, and its
per-step account of host time.

`span(name)` is a timed range.  While the profiler runs
(`torch.autograd._profiler_enabled()`) it is a `torch.profiler.record_function`
range of that name, on the device trace's timeline; with the profiler off it
opens none (on an H100 machine's host, torch 2.11: a `record_function` ~11-22
us an enter and exit, a span ~2 us).  While a step record is open on the
thread, the span adds its count, inclusive and self nanoseconds
(`time.perf_counter_ns`; self is the duration less its child spans') to the
record, by name.  A span leaves the name stack alone.

`scope(name)` is a span that also pushes its name onto a per-thread stack,
which the collective capture (`repro_torch.core.capture`) reads (a dispatch
mode cannot see the profiler's open ranges).  Model, loss and optimizer code
open the ranges the capture attributes to through it; every other range is a
`span`.

`step(kind, rows, length)` opens a step record and its root span
(`<kind>_step`); the launch steps (`launch/steps.py`) open one per call.  A
closed record (`StepRecord`) goes to `steps`, a deque of the last 4096, in the
order the steps ended.  Spans opened on a thread with no open step are not
counted: the autograd engine's own thread, which runs a CUDA backward and the
remat's recompute, adds nothing (its spans are still ranges while profiling).
A step opened inside another is a span of the outer one.  `record(False)`
stops the recording; it is on from import.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional, Tuple

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_local = threading.local()
# the autograd-node metadata key under which a node's forward scope path is kept
NODE_KEY = "scope"
LOG_STEPS = 4096

steps: deque = deque(maxlen=LOG_STEPS)   # the last closed StepRecords, oldest first
_ids = itertools.count(1)
_recording = True


@dataclass
class StepRecord:
    """One step's host account.  `start_ns`/`end_ns` are `perf_counter_ns`
    reads; `unix_start_ns`/`unix_end_ns` the same instants in Unix nanoseconds,
    the clock of the profiler's host events (an anchor read at the step's
    entry).  `spans`: {name: (count, inclusive_ns, self_ns)}, the root span's
    included; `counters`: each kernel counter's change over the step;
    `profiled`: whether the profiler ran at its entry (the root range then
    carries `id` as its args)."""
    id: int
    kind: str
    rows: int
    length: int
    profiled: bool
    start_ns: int = 0
    end_ns: int = 0
    unix_start_ns: int = 0
    unix_end_ns: int = 0
    spans: Dict[str, Tuple[int, int, int]] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)


def record(on: bool = True) -> None:
    """Switch step records on or off; spans are ranges while profiling either way."""
    global _recording
    _recording = on


def current() -> Tuple[str, ...]:
    """The names of the scopes open on this thread, outermost first."""
    return tuple(getattr(_local, "names", ()))


def mark(t):
    """Record the open scope path on `t`'s autograd node, unless it has one: for
    a node made by an autograd Function (a sharding constraint, `local_map`),
    which the capture's function mode does not see made.  Returns `t`."""
    node = getattr(t, "grad_fn", None)
    if node is not None and NODE_KEY not in node.metadata:
        node.metadata[NODE_KEY] = current()
    return t


class span:
    """A timed range (see the module's docstring): `with span("norm"): ...`."""
    __slots__ = ("name", "_range", "_rec", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._rec = rec = getattr(_local, "rec", None)
        if rec is not None:
            rec.kids.append(0)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            d = time.perf_counter_ns() - self._t0
            own = d - rec.kids.pop()
            rec.kids[-1] += d
            s = rec.acc.get(self.name)
            if s is None:
                rec.acc[self.name] = [1, d, own]
            else:
                s[0] += 1
                s[1] += d
                s[2] += own
        if self._range is not None:
            self._range.__exit__(*exc)


@contextmanager
def scope(name: str) -> Iterator[None]:
    names = getattr(_local, "names", None)
    if names is None:
        names = _local.names = []
    names.append(name)
    try:
        with span(name):
            yield
    finally:
        names.pop()


class _Open:
    """A step record while it is open: its spans' sums and the child time of
    each open span, the root's first."""
    __slots__ = ("acc", "kids")

    def __init__(self):
        self.acc, self.kids = {}, [0]


@contextmanager
def step(kind: str, rows: int, length: int,
         counters: Optional[Callable[[], Dict[str, int]]] = None) -> Iterator[Optional[StepRecord]]:
    """Open a step record of `kind` ("prefill", "decode", "train") and shape
    (rows, length), with its root span `<kind>_step`; yields the record (None
    when not recording, or inside another step).  `counters()`, read at entry
    and exit, gives the kernel counters whose change the record keeps."""
    name = f"{kind}_step"
    if not _recording or getattr(_local, "rec", None) is not None:
        with span(name):
            yield None
        return
    rec = StepRecord(next(_ids), kind, int(rows), int(length), _profiler_enabled())
    before = counters() if counters is not None else {}
    rng = record_function(name, str(rec.id)) if rec.profiled else None
    if rng is not None:
        rng.__enter__()
    _local.rec = acc = _Open()
    rec.start_ns, rec.unix_start_ns = time.perf_counter_ns(), time.time_ns()
    try:
        yield rec
    finally:
        rec.end_ns = time.perf_counter_ns()
        _local.rec = None
        if rng is not None:
            rng.__exit__(None, None, None)
        d = rec.end_ns - rec.start_ns
        rec.unix_end_ns = rec.unix_start_ns + d
        rec.spans = {k: tuple(v) for k, v in acc.acc.items()}
        rec.spans[name] = (1, d, d - acc.kids[0])
        if counters is not None:
            rec.counters = {k: v - before[k] for k, v in counters().items()}
        steps.append(rec)
