"""The capture dump: a captured step's trace as a file that a running rank
writes and the ingest path reads back.

The reference ingests the HLO text that XLA dumps while a job runs
(`--xla_dump_to`), through its tracer and its HLO parser, whose salvage
mode recovers the intact computations of a damaged module.  A PyTorch job
has no HLO: its counterpart of "the module the compiler dumps" is the
trace that `core.capture.trace_step` returns on each rank.  This module is
the file of that trace and its reader, with the same salvage contract.

Format (UTF-8, one JSON object a line):

  * a header: `format` (`FORMAT`), `version`, the trace's `label`,
    `mesh_shape`, `mesh_axes`, `axis_kind` (the links it was priced on),
    `num_devices`, its scalars (`hlo_flops`, `hlo_bytes`,
    `hlo_bytes_unfused`, `per_device_memory_bytes`, `argument_bytes`,
    `output_bytes`), `op_stats`, and the order of the store's interned
    vocabularies and payload tables (`vocab`, `tables`);
  * one line a site row: `i`, its row index, and the `CollectiveEvent`
    fields that `TraceStore.rows()` gives, pricing included;
  * a footer: `rows`, the row count.

`write_capture` writes it line by line, flushing, and does not land the
file atomically (as XLA's dump does not): a reader polling the directory
can see a file being written, which is why the watch daemon waits for a
file's size and mtime to settle.  Ingest keeps the capture's own pricing
(the H100 model on the job's mesh, `axis_kind` included); re-pricing is the
what-if sweep's job.

`trace_from_capture` reads it back through `TraceStore.from_events`, with
the interned vocabularies and payload tables put back in the writer's
order, so the round trip gives an `identical` store.
A strict read raises `ValueError` on any damage: a line that is not a JSON
object of the right fields, a missing footer, a row count that disagrees
with it, a repeated or out-of-order row index, or a header mesh that
differs from the caller's.  `recover=True` is the reference's salvage
parse (`hlo_parser.parse_hlo_store(recover=True)`): it keeps the header
and every intact row (the first copy of a repeated index), and
`trace.salvage` carries a `SalvageReport` of what was lost, its
"computations" read as rows.  A capture with no intact header salvages its
intact rows on the caller's mesh, with no scalars (none at all, as a module
with no intact computation does in the reference, when nothing is left).
Bytes that are not UTF-8 fail before either read, when the file is decoded
(`read_capture`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import CollectiveEvent, HloOpStats, Trace
from repro_torch.core.store import Categorical, TraceStore
from repro_torch.core.topology import MeshSpec

FORMAT = "repro_torch.capture"
VERSION = 1

_SCALARS = ("hlo_flops", "hlo_bytes", "hlo_bytes_unfused", "per_device_memory_bytes",
            "argument_bytes", "output_bytes")
# a row's fields and the types a strict read holds them to
_FIELDS: Tuple[Tuple[str, tuple], ...] = (
    ("name", (str,)), ("kind", (str,)), ("async_start", (bool,)),
    ("operand_bytes", (int,)), ("result_bytes", (int,)), ("dtype", (str,)),
    ("replica_groups", (list,)), ("group_size", (int,)), ("num_groups", (int,)),
    ("op_name", (str,)), ("computation", (str,)), ("multiplicity", (int,)),
    ("channel_id", (int, type(None))), ("source_target_pairs", (list, type(None))),
    ("link_class", (str,)), ("axes", (list,)), ("semantic", (str,)),
    ("jax_prim", (str,)), ("scope", (str,)), ("protocol", (str,)),
    ("wire_bytes_per_device", (float, int)), ("est_time_s", (float, int)),
)
# the store's interned columns whose first-seen order the header keeps
_VOCAB = ("kind", "link_class", "semantic", "protocol", "jax_prim", "scope", "dtype",
          "computation", "op_name")


@dataclass
class SalvageReport:
    """What a salvage read dropped from a damaged capture (the reference's
    `hlo_parser.SalvageReport`, its computations read as rows).

    `total_bytes` and `bytes_skipped` count UTF-8 bytes; `computations_total`
    is the footer's row count when the footer is intact, else the rows and
    damaged lines seen; `dropped` names each damaged line, repeated copy and
    missing row.  A capture cut at a line boundary loses no byte but its
    footer: `first_error` says so, and it is not `clean`.
    """

    total_bytes: int = 0
    bytes_skipped: int = 0
    computations_total: int = 0
    computations_dropped: int = 0
    dropped: List[str] = field(default_factory=list)
    first_error: str = ""

    @property
    def clean(self) -> bool:
        """True when nothing was dropped and nothing was missing."""
        return (self.bytes_skipped == 0 and self.computations_dropped == 0
                and not self.first_error)

    def to_dict(self) -> Dict[str, object]:
        return {
            "clean": self.clean,
            "total_bytes": int(self.total_bytes),
            "bytes_skipped": int(self.bytes_skipped),
            "computations_total": int(self.computations_total),
            "computations_dropped": int(self.computations_dropped),
            "dropped": list(self.dropped),
            "first_error": self.first_error,
        }


def capture_path(root: str, host: int, step: int) -> str:
    """`root/host{h:03d}_step{s:03d}.jsonl`: the fleet naming that
    `session.label_meta` reads host and step off."""
    return os.path.join(root, f"host{int(host):03d}_step{int(step):03d}.jsonl")


def _header(trace: Trace, mesh: Optional[MeshSpec]) -> Dict[str, object]:
    if mesh is None:
        mesh = MeshSpec(tuple(trace.mesh_shape), tuple(trace.mesh_axes))
    store = trace.store
    head = {"format": FORMAT, "version": VERSION, "label": trace.label,
            "mesh_shape": list(trace.mesh_shape), "mesh_axes": list(trace.mesh_axes),
            "axis_kind": dict(mesh.axis_kind), "num_devices": int(trace.num_devices)}
    head.update({k: float(getattr(trace, k)) for k in _SCALARS})
    head["op_stats"] = dataclasses.asdict(trace.op_stats)
    head["vocab"] = {c: list(getattr(store, c).vocab) for c in _VOCAB}
    head["tables"] = {
        "groups": [[list(map(int, g)) for g in t] for t in store.group_tables],
        "pairs": [[[int(a), int(b)] for a, b in t] for t in store.stp_tables],
        "axes": [list(t) for t in store.axes_tables]}
    return head


def _row(i: int, e: CollectiveEvent) -> Dict[str, object]:
    d = {"i": i}
    for name, _types in _FIELDS:
        v = getattr(e, name)
        if name == "source_target_pairs" and v is not None:
            v = [[int(a), int(b)] for a, b in v]
        elif name == "replica_groups":
            v = [list(map(int, g)) for g in v]
        elif name == "axes":
            v = list(v)
        d[name] = v
    return d


def capture_lines(trace: Trace, mesh: Optional[MeshSpec] = None):
    """The capture's lines, each ending in a newline: header, rows, footer."""
    yield json.dumps(_header(trace, mesh), separators=(",", ":")) + "\n"
    store = trace.store
    for i in range(store.n):
        yield json.dumps(_row(i, store.row(i)), separators=(",", ":")) + "\n"
    yield json.dumps({"rows": store.n}) + "\n"


def capture_text(trace: Trace, mesh: Optional[MeshSpec] = None) -> str:
    """The whole capture as one string (what `write_capture` writes)."""
    return "".join(capture_lines(trace, mesh))


def write_capture(trace: Trace, path: str, mesh: Optional[MeshSpec] = None) -> int:
    """Write `trace` to `path` line by line, flushing each line, not
    atomically; returns the bytes written.  `mesh` gives the `axis_kind`
    the trace was priced on (default: the mesh shape's own)."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for line in capture_lines(trace, mesh):
            f.write(line)
            f.flush()
            n += len(line.encode("utf-8"))
    return n


def read_capture(path: str) -> str:
    """A capture file's text; bytes that are not UTF-8 raise
    `UnicodeDecodeError` (an unreadable input, quarantined by ingest)."""
    with open(path, encoding="utf-8") as f:
        return f.read()


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def _check_header(head) -> None:
    if not isinstance(head, dict) or head.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} header")
    if head.get("version") != VERSION:
        raise ValueError(f"capture version {head.get('version')!r} is not {VERSION}")
    for key in ("label", "mesh_shape", "mesh_axes", "num_devices", "op_stats"):
        if key not in head:
            raise ValueError(f"capture header has no {key!r}")
    try:
        _mesh_of(head), int(head["num_devices"]), HloOpStats(**head["op_stats"])
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad capture header ({e})") from None


def _event(d) -> Tuple[int, CollectiveEvent]:
    """(row index, event) of one row object; ValueError on a bad row."""
    if not isinstance(d, dict) or set(d) != {"i"} | {n for n, _ in _FIELDS}:
        raise ValueError("not a capture row")
    if type(d["i"]) is not int or d["i"] < 0:
        raise ValueError(f"bad row index {d['i']!r}")
    for name, types in _FIELDS:
        v = d[name]
        if not any(type(v) is t for t in types):
            raise ValueError(f"row {d['i']}: {name} is {type(v).__name__}")
    groups = d["replica_groups"]
    if not all(isinstance(g, list) and all(type(x) is int for x in g) for g in groups):
        raise ValueError(f"row {d['i']}: bad replica_groups")
    pairs = d["source_target_pairs"]
    if pairs is not None and not all(
            isinstance(p, list) and len(p) == 2 and all(type(x) is int for x in p)
            for p in pairs):
        raise ValueError(f"row {d['i']}: bad source_target_pairs")
    if not all(type(a) is str for a in d["axes"]):
        raise ValueError(f"row {d['i']}: bad axes")
    kw = {n: d[n] for n, _ in _FIELDS}
    kw["source_target_pairs"] = None if pairs is None else [tuple(p) for p in pairs]
    kw["axes"] = tuple(d["axes"])
    kw["wire_bytes_per_device"] = float(d["wire_bytes_per_device"])
    kw["est_time_s"] = float(d["est_time_s"])
    return d["i"], CollectiveEvent(**kw)


def _mesh_of(head) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    return tuple(int(x) for x in head["mesh_shape"]), tuple(head["mesh_axes"])


def _store(events: List[CollectiveEvent], head) -> TraceStore:
    """The rows' store with the writer's vocabulary and table orders, where
    the header gives them and they cover the rows (else first-seen order)."""
    store = TraceStore.from_events(events)
    vocab, tables = head.get("vocab"), head.get("tables")
    if not isinstance(vocab, dict) or not isinstance(tables, dict):
        return store

    def reorder(codes, have, want, key=lambda v: v):
        index = {key(v): j for j, v in enumerate(want)}
        remap = np.array([index.get(key(v), -1) for v in have], dtype=np.int32)
        if len(have) and (remap < 0).any():
            return None
        return remap[codes] if len(codes) else codes
    try:
        for col in _VOCAB:
            cat, want = getattr(store, col), vocab[col]
            codes = reorder(cat.codes, cat.vocab, want)
            if codes is None:
                return TraceStore.from_events(events)
            setattr(store, col, Categorical(codes, list(want)))
        gkey = lambda t: tuple(tuple(g) for g in t)  # noqa: E731
        pkey = lambda t: tuple(tuple(p) for p in t)  # noqa: E731
        plan = (("group", store.group_tables, tables["groups"], gkey),
                ("stp", store.stp_tables, tables["pairs"], pkey),
                ("axes", store.axes_tables, tables["axes"], tuple))
        new = {}
        for name, have, want, key in plan:
            code = getattr(store, f"{name}_code")
            valid = code >= 0
            got = reorder(code[valid], have, want, key)
            if got is None:
                return TraceStore.from_events(events)
            out = code.copy()
            out[valid] = got
            new[name] = out
    except (KeyError, TypeError, ValueError):
        return TraceStore.from_events(events)
    store.group_tables = [[list(g) for g in t] for t in tables["groups"]]
    store.group_code = new["group"]
    store.stp_tables = [[tuple(p) for p in t] for t in tables["pairs"]]
    store.stp_code = new["stp"]
    store.set_axes([tuple(t) for t in tables["axes"]], new["axes"])
    return store


def _trace(head, events, label, mesh) -> Trace:
    if head is None:
        shape, axes, nd = mesh.shape, mesh.axes, mesh.num_devices
        stats, scalars, store = HloOpStats(), {}, TraceStore.from_events(events)
    else:
        (shape, axes), nd = _mesh_of(head), int(head["num_devices"])
        stats = HloOpStats(**head["op_stats"])
        scalars = {k: float(head.get(k, 0.0)) for k in _SCALARS}
        store = _store(events, head)
    unfused = scalars.pop("hlo_bytes_unfused", None)
    tr = Trace.from_store(label if label is not None else
                          (head["label"] if head else "capture"),
                          shape, axes, nd, store, op_stats=stats, **scalars)
    if unfused is not None:
        tr.hlo_bytes_unfused = unfused
    return tr


def trace_from_capture(text: str, mesh: Optional[MeshSpec] = None, *,
                       label: Optional[str] = None, recover: bool = False) -> Trace:
    """Rebuild the `Trace` a capture holds (see the module docstring).

    `mesh`, when given, must have the header's shape and axes (a strict and
    a salvage read both raise otherwise); `label` replaces the header's
    (ingest labels a trace by its file's stem).  With `recover=True` the
    returned trace carries `trace.salvage`.
    """
    lines = text.split("\n")
    rep = SalvageReport(total_bytes=len(text.encode("utf-8")))
    # damaged lines: (row index if the line names one, where, error)
    bad: List[Tuple[Optional[int], str, str]] = []

    def damaged(where: str, line: str, err: str, newline: bool, row=None) -> None:
        if not recover:
            raise ValueError(f"{where}: {err}")
        bad.append((row, where, err))
        rep.bytes_skipped += len(line.encode("utf-8")) + int(newline)
        if not rep.first_error:
            rep.first_error = f"{where}: {err}"

    first = 1
    try:
        head = json.loads(lines[0])
        _check_header(head)
    except (ValueError, AttributeError) as e:
        if not recover:
            raise ValueError(f"line 1: {e}") from None
        if mesh is None:
            raise ValueError("a capture with no header needs the caller's mesh") from None
        # the rows stand without it, on the caller's mesh with no scalars;
        # line 1 is read as a body line (a row, if the header was lost whole)
        rep.first_error = f"no capture header (line 1: {e})"
        head, first = None, 0
    if head is not None and mesh is not None and _mesh_of(head) != (mesh.shape, mesh.axes):
        raise ValueError(f"capture mesh {_mesh_of(head)} is not the mesh given "
                         f"{(mesh.shape, mesh.axes)}")

    rows: Dict[int, CollectiveEvent] = {}
    footer: Optional[int] = None
    last = -1
    for k in range(first, len(lines)):
        line, where, newline = lines[k], f"line {k + 1}", k + 1 < len(lines)
        if line == "" and not newline:
            continue                     # after the final newline
        if footer is not None:
            damaged(where, line, "text after the footer", newline)
            continue
        try:
            d = json.loads(line)
        except ValueError as e:
            damaged(where, line, f"not JSON ({e})", newline)
            continue
        if isinstance(d, dict) and set(d) == {"rows"} and type(d["rows"]) is int:
            footer = d["rows"]
            continue
        try:
            i, ev = _event(d)
        except ValueError as e:
            i = d.get("i") if isinstance(d, dict) else None
            damaged(where, line, str(e), newline, i if type(i) is int else None)
            continue
        if i in rows:
            # a repeated copy: its bytes are skipped, the first copy is kept
            damaged(where, line, f"row {i} repeated", newline, i)
            continue
        if i < last:
            if not recover:
                raise ValueError(f"{where}: row {i} after row {last}")
            # kept, in index order; the report says the order was broken
            rep.first_error = rep.first_error or f"{where}: row {i} after row {last}"
        rows[i] = ev
        last = max(last, i)
    if not recover and footer is None:
        raise ValueError("no footer: the capture was cut")
    if not recover and (footer != len(rows) or sorted(rows) != list(range(footer))):
        raise ValueError(f"footer counts {footer} rows, the capture holds {len(rows)}")
    if recover:
        # what was lost, as rows: with the footer, every index it counts that
        # no intact line holds; without it, every damaged line not a repeat
        named = {r: w for r, w, _ in bad if r is not None and r not in rows}
        if footer is None:
            if not rep.first_error:
                rep.first_error = "no footer: the capture was cut"
            rep.dropped = [w if r is None else f"row {r} ({w})" for r, w, _ in bad
                           if r is None or r not in rows]
            rep.computations_total = len(rows) + len(rep.dropped)
        else:
            extra = sorted(i for i in rows if i >= footer)
            for i in extra:
                del rows[i]
            rep.dropped = [f"row {i} ({named.get(i, 'missing')})"
                           for i in range(footer) if i not in rows]
            rep.dropped += [f"row {i} (past the footer's count)" for i in extra]
            if rep.dropped and not rep.first_error:
                rep.first_error = f"footer counts {footer} rows, {len(rows)} intact"
            rep.computations_total = footer
        rep.computations_dropped = len(rep.dropped)
    tr = _trace(head, [rows[i] for i in sorted(rows)], label, mesh)
    if recover:
        tr.salvage = rep
    return tr
