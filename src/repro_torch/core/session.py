"""TraceSession — named multi-trace collections with save/load + comparison
(a copy of the reference's `core/session.py`).

The paper's headline experiments are *comparisons across runs*: the same
Allreduce workload under different MPI libraries, UCX settings, and NUMA
bindings.  A `TraceSession` makes that shape first-class: collect traces
from several configurations (the port's captures, `core.trace_step`),
persist them as one artifact (compact JSON or compressed npz of the
columnar stores), and render n-way comparison views.

The file format is the reference's: a session saved by either package
loads in the other, with the same columns and scalars.

Bulk ingest (`TraceSession.from_captures`) reads many capture dumps
(`core.dump`: the file a running rank writes of its captured step, the
port's counterpart of the HLO dumps the reference's `from_hlo` parses),
fanning the files out across worker processes.  The reference splits one
large module across workers by its computations (`--shards`); a capture
has no computations, and is small (one line a collective site), so the
port has no counterpart of that.

CLI:
    python -m repro_torch.core.session demo  [--out PATH] [--format json|npz]
    python -m repro_torch.core.session ingest OUT FILE [FILE ...] [--mesh 2,4]
                                        [--axes data,model] [--workers N]
                                        [--errors raise|skip|salvage]
                                        [--retries N] [--timeout S] [--json]
    python -m repro_torch.core.session show  PATH
    python -m repro_torch.core.session table PATH [--by kind_link|semantic|site] \\
                                            [--metric bytes|time|count]
    python -m repro_torch.core.session diff  PATH LABEL_A LABEL_B [--by ...|site] \\
                                        [--top N] [--only-regressed] [--json] \\
                                        [--mmap]
    python -m repro_torch.core.session query PATH [--host GLOB] [--step N|GLOB] \\
                                        [--op GLOB] [--kind GLOB] \\
                                        [--by kind_link|semantic|site] \\
                                        [--json] [--mmap]
    python -m repro_torch.core.session report PATH [LABEL] [--format json|html] \\
                                        [--out FILE] [--stream] \\
                                        [--chunk-sites N]
    python -m repro_torch.core.session watch ROOT [--pattern *.jsonl] [--mesh 2,4] \\
                                        [--axes data,model] [--out PATH] \\
                                        [--report-json PATH] \\
                                        [--report-html PATH] \\
                                        [--summary PATH] [--settle S] \\
                                        [--interval S] [--once] \\
                                        [--fail-on SEV] [--max-rounds N] \\
                                        [--errors raise|skip|salvage] \\
                                        [--checkpoint PATH]
    python -m repro_torch.core.session lint  PATH [PATH ...] [--mesh 2,4] \\
                                        [--axes data,model] [--json] \\
                                        [--fail-on critical|warn|info|never]
    python -m repro_torch.core.session detect PATH [LABEL] [--json] \\
                                        [--fail-on critical|warn|info|never]
    python -m repro_torch.core.session whatif PATH [LABEL] [--mesh 2,4] \\
                                        [--axes data,model] [--top N] [--json]

`lint` runs the static analyzer (`commcheck`) over saved sessions
(.json/.npz) or capture dumps (.jsonl, read on --mesh/--axes); `detect`
runs the dynamic detectors over a saved session.  Both emit the same stable
finding schema under --json and exit 1 when any finding reaches the
--fail-on severity (default: critical for lint, never for detect), 2 on
input errors: a missing file, a file that is neither a session nor a
capture (the reference's HLO text among them), or a capture whose header
mesh is not --mesh/--axes.

`whatif` is the hardwareless config sweep (`repro_torch.core.whatif`): it
re-prices one trace of a saved session or a capture dump under a grid of
counterfactual scenarios — mesh axis permutations, rendezvous-threshold
tiers, NVLink and InfiniBand bandwidth/latency tiers — by re-running the
columnar annotation pass (no re-capture, no hardware), and ranks the
scenarios by estimated step time saved.  Exits 0 on success, 2 on input
errors.

`watch` is the live-profiling daemon (see `repro_torch.core.watch`): it
tails a directory that running ranks write capture dumps into, ingests
new/changed files incrementally (append-mode stores + streaming
detector/lint state), and re-emits its outputs atomically every poll;
`--once` drains the directory and exits.  Damaged dumps are salvaged or
quarantined instead of crashing the loop (exit 3 when anything was
degraded, after the `--fail-on` alert exit 1), and `--checkpoint` makes the
daemon crash-resumable.

`ingest` exits 0 on full success; with `--errors=skip|salvage` it exits
3 when any input was skipped, salvaged or quarantined (the session is
still written, carrying the machine-readable ingest report), and 2 for
hard failures.

`query` is the warehouse slice view: filter the session's traces by
host/step (parsed from trace labels, `host012_step003`-style) and its
rows by op/kind globs, then aggregate the slice — without merging or
materializing anything.  `diff` and `report` accept the same slice
specs (`host=00*,step=1`) in place of a trace label: matching traces
tree-merge into one side of the comparison.  `--mmap` opens an
*uncompressed* npz (`ingest --no-compress`) zero-copy, so fleet-scale
sessions slice without loading; exit codes follow `detect`/`lint`
(0 ok, 2 input errors).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import re
import sys
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.events import HloOpStats, Trace
from repro_torch.core.persist import atomic_open, open_npz_mmap, write_npz
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import MeshSpec

_TRACE_SCALARS = ("hlo_flops", "hlo_bytes", "per_device_memory_bytes",
                  "argument_bytes", "output_bytes")


# --------------------------------------------------------------------------
# Trace <-> dict (rides on the columnar store serialization)
# --------------------------------------------------------------------------

def trace_to_dict(trace: Trace) -> Dict[str, object]:
    return {**_trace_meta(trace), "store": trace.store.to_dict()}


def trace_from_dict(d: Dict[str, object]) -> Trace:
    return _trace_from_meta(d, TraceStore.from_dict(d["store"]))


def _trace_meta(trace: Trace) -> Dict[str, object]:
    return {
        "label": trace.label,
        "mesh_shape": list(trace.mesh_shape),
        "mesh_axes": list(trace.mesh_axes),
        "num_devices": trace.num_devices,
        "scalars": {k: getattr(trace, k) for k in _TRACE_SCALARS},
        "op_stats": dataclasses.asdict(trace.op_stats),
    }


def _trace_from_meta(meta: Dict[str, object], store: TraceStore) -> Trace:
    return Trace.from_store(
        meta["label"], tuple(meta["mesh_shape"]), tuple(meta["mesh_axes"]),
        int(meta["num_devices"]), store,
        op_stats=HloOpStats(**meta["op_stats"]),
        **{k: float(v) for k, v in meta["scalars"].items()})


# --------------------------------------------------------------------------
# warehouse label metadata + slice specs
# --------------------------------------------------------------------------

# fleet dump naming convention: labels (= file stems) carry the host id
# and step index, e.g. "host012_step003".  The host capture requires a
# non-letter (or start) before "host" so e.g. "localhost" doesn't match.
_HOST_RE = re.compile(r"(?:^|[^A-Za-z])host[_-]?([0-9A-Za-z]+)")
_STEP_RE = re.compile(r"(?:^|[^A-Za-z])step[_-]?([0-9]+)")

_SLICE_KEYS = ("host", "step", "op", "kind")


def label_meta(label: str) -> Dict[str, object]:
    """Parse per-trace warehouse metadata out of a trace label.

    Returns a dict with `host` (string id) and/or `step` (int) when the
    label follows the `host012_step003` fleet-dump convention; keys are
    absent when the label carries no such marker.  This is the per-trace
    extension of the `IngestReport` per-file provenance — labels are
    file stems, so the ingest record and the trace agree.
    """
    meta: Dict[str, object] = {}
    m = _HOST_RE.search(label)
    if m:
        meta["host"] = m.group(1)
    m = _STEP_RE.search(label)
    if m:
        meta["step"] = int(m.group(1))
    return meta


def parse_slice(spec: str) -> Dict[str, str]:
    """Parse a `host=00*,step=3,op=*,kind=*` slice spec into kwargs.

    The CLI accepts these wherever a trace label is expected (`diff`,
    `report`) and as the `query` filter flags; unknown keys and bare
    words raise `ValueError` (CLI exit 2).
    """
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad slice spec {part!r}: expected key=value with key "
                f"in {'/'.join(_SLICE_KEYS)}")
        k, v = part.split("=", 1)
        if k not in _SLICE_KEYS:
            raise ValueError(
                f"unknown slice key {k!r} (expected one of "
                f"{'/'.join(_SLICE_KEYS)})")
        if not v:
            raise ValueError(f"empty value for slice key {k!r} "
                             f"(use {k}=* to match everything)")
        out[k] = v
    return out


def _step_match(step: int, spec: str) -> bool:
    """Match a parsed step index against a numeric or glob spec."""
    spec = str(spec)
    if spec.isdigit():
        return step == int(spec)
    return (fnmatch.fnmatchcase(str(step), spec)
            or fnmatch.fnmatchcase(f"{step:03d}", spec))


# --------------------------------------------------------------------------
# bulk ingest — many capture dumps -> one session, fanned out across processes
# --------------------------------------------------------------------------

class IngestError(RuntimeError):
    """A specific input failed to ingest.

    Raised by `TraceSession.from_captures` with the offending file/label in
    the message (chained to the original error) — a genuine per-file
    failure must not be mistaken for pool unavailability and silently
    retried serially.
    """


@dataclasses.dataclass
class IngestRecord:
    """Per-input provenance of one `from_captures` ingest (the reference's
    `from_hlo` writes the same record; a saved session keeps it).

    `status` is the outcome class:
      * `ok`          — read cleanly (possibly after retries);
      * `salvaged`    — the strict read failed, the salvage read recovered
        a partial trace (`salvage` holds the `SalvageReport` dict);
      * `skipped`     — failed under `errors="skip"`, input excluded;
      * `quarantined` — failed even recovery (unreadable bytes, a header
        mesh that is not the ingest's, hung worker that also failed
        serially), input excluded.
    """

    source: str
    label: str
    status: str = "ok"
    attempts: int = 1
    error: str = ""
    salvage: Optional[Dict[str, object]] = None
    # warehouse provenance, derived from the label's fleet-dump naming
    # convention when not given (see `label_meta`); "" / None = unknown
    host: str = ""
    step: Optional[int] = None

    def __post_init__(self) -> None:
        if not self.host and self.step is None:
            meta = label_meta(self.label)
            self.host = str(meta.get("host", ""))
            self.step = meta.get("step")

    def to_dict(self) -> Dict[str, object]:
        return {"source": self.source, "label": self.label,
                "status": self.status, "attempts": int(self.attempts),
                "error": self.error, "salvage": self.salvage,
                "host": self.host, "step": self.step}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "IngestRecord":
        return cls(source=d["source"], label=d["label"],
                   status=d.get("status", "ok"),
                   attempts=int(d.get("attempts", 1)),
                   error=d.get("error", ""), salvage=d.get("salvage"),
                   host=str(d.get("host", "")), step=d.get("step"))


@dataclasses.dataclass
class IngestReport:
    """Machine-readable record of every input a bulk ingest touched.

    Attached to the session `from_captures` returns (and persisted with
    it), so a partial session carries the provenance of what was skipped,
    salvaged, or quarantined — the contract the `session ingest` exit
    codes (0 clean / 3 degraded) and the watch-daemon summary build on.
    """

    errors: str = "raise"
    records: List[IngestRecord] = dataclasses.field(default_factory=list)

    @property
    def degraded(self) -> List[IngestRecord]:
        return [r for r in self.records if r.status != "ok"]

    @property
    def ok(self) -> bool:
        return not self.degraded

    def to_dict(self) -> Dict[str, object]:
        return {"errors": self.errors,
                "records": [r.to_dict() for r in self.records]}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "IngestReport":
        return cls(errors=d.get("errors", "raise"),
                   records=[IngestRecord.from_dict(r)
                            for r in d.get("records", ())])


def _retry_delays(retries: int, backoff_s: float):
    """Exponential backoff schedule: backoff, 2*backoff, 4*backoff, ..."""
    return [backoff_s * (1 << i) for i in range(max(retries, 0))]


def _ingest_one(job) -> Trace:
    """Worker: read one (label, capture text) strictly into its trace.

    Module-level so it pickles into `ProcessPoolExecutor` workers; the
    returned `Trace` ships back as its columnar store (rows stay lazy).
    """
    label, text, mesh = job
    from repro_torch.core.dump import trace_from_capture
    return trace_from_capture(text, mesh, label=label)


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _read_text(path) -> str:
    from repro_torch.core.dump import read_capture
    return read_capture(path)


def _ingest_jobs(items, mesh: MeshSpec, *, errors: str = "raise",
                 retries: int = 0, backoff_s: float = 0.0) -> List:
    """One entry per input: (source, item, job | None, IngestRecord | None).

    A `None` job means the input could not even be read (missing file,
    undecodable bytes); under a non-raise policy that failure is
    pre-recorded as quarantined — after read retries with backoff, the
    file may still be landing — instead of raised, and the entry is
    excluded from parsing.
    """
    entries = []
    for it in items:
        if isinstance(it, (tuple, list)):
            label, text = it
            entries.append((label, it, (label, text, mesh), None))
            continue
        src = str(it)
        label = os.path.splitext(os.path.basename(src))[0]
        attempts, err, text = 1, None, None
        try:
            text = _read_text(src)
        except Exception as e:
            err = e
            if errors == "raise":
                if isinstance(e, FileNotFoundError):
                    raise      # CLI reports the filename specially
                raise IngestError(f"failed to read {src!r}: {e}") from e
            for delay in _retry_delays(retries, backoff_s):
                time.sleep(delay)
                attempts += 1
                try:
                    text = _read_text(src)
                    err = None
                    break
                except Exception as e2:
                    err = e2
        if err is not None:
            entries.append((src, it, None,
                            IngestRecord(src, label, "quarantined", attempts,
                                         error=_errstr(err))))
        else:
            entries.append((src, it, (label, text, mesh), None))
    return entries


def _recover_one(src: str, item, job, err: BaseException, errors: str,
                 retries: int, backoff_s: float):
    """Recovery ladder for one input whose strict read failed.

    retry with exponential backoff (re-reading path inputs — the dump
    may have still been landing) -> salvage read (`errors="salvage"`) ->
    skip/quarantine.  Returns (Trace | None, IngestRecord); a None trace
    means the input is excluded.
    """
    label, text, mesh = job
    attempts, last = 1, err
    for delay in _retry_delays(retries, backoff_s):
        if delay > 0:
            time.sleep(delay)
        attempts += 1
        try:
            if not isinstance(item, (tuple, list)):
                text = _read_text(item)
            return (_ingest_one((label, text, mesh)),
                    IngestRecord(src, label, "ok", attempts))
        except Exception as e:
            last = e
    if errors == "salvage" and isinstance(text, str):
        from repro_torch.core.dump import trace_from_capture
        try:
            tr = trace_from_capture(text, mesh, label=label, recover=True)
            return tr, IngestRecord(src, label, "salvaged", attempts,
                                    error=_errstr(last),
                                    salvage=tr.salvage.to_dict())
        except Exception as e:
            last = e
    status = "skipped" if errors == "skip" else "quarantined"
    return None, IngestRecord(src, label, status, attempts,
                              error=_errstr(last))


class TraceSession:
    """An ordered, label-addressed collection of traces."""

    def __init__(self, name: str, traces: Optional[Sequence[Trace]] = None):
        self.name = name
        # provenance of the bulk ingest that built this session (set by
        # `from_captures`, persisted through save/load); None for captured,
        # hand-built or legacy-loaded sessions
        self.ingest_report: Optional[IngestReport] = None
        self._traces: List[Trace] = []
        for t in traces or ():
            self.add(t)

    # -- collection interface -----------------------------------------------

    def add(self, trace: Trace) -> Trace:
        if trace.label in self.labels():
            raise ValueError(f"duplicate trace label {trace.label!r} "
                             f"in session {self.name!r}")
        self._traces.append(trace)
        return trace

    def labels(self) -> List[str]:
        return [t.label for t in self._traces]

    def get(self, label: str) -> Trace:
        for t in self._traces:
            if t.label == label:
                return t
        raise KeyError(f"no trace {label!r} in session {self.name!r} "
                       f"(have {self.labels()})")

    def __len__(self) -> int:
        return len(self._traces)

    def __iter__(self) -> Iterator[Trace]:
        return iter(self._traces)

    # -- aggregate views -----------------------------------------------------

    def aggregate(self, by: str = "kind_link") -> Dict[str, Dict[str, Dict[str, float]]]:
        """{trace label: {traffic class: {bytes, wire_bytes, count, time_s}}}."""
        fn = {"kind_link": lambda t: t.by_kind_and_link(),
              "semantic": lambda t: t.by_semantic()}[by]
        return {t.label: fn(t) for t in self._traces}

    def totals(self) -> List[Dict[str, float]]:
        """Per-trace one-line summaries (the session overview rows)."""
        return [{
            "label": t.label,
            "sites": t.store.n,
            "collectives_per_step": float(t.store.multiplicity.sum()),
            "collective_gb": t.total_collective_bytes() / 1e9,
            "wire_gb": t.total_wire_bytes() / 1e9,
            "est_ms": t.total_est_time_s() * 1e3,
            "overlapped_ms": t.overlapped_est_time_s() * 1e3,
        } for t in self._traces]

    def table(self, by: str = "kind_link", metric: str = "bytes") -> str:
        from repro_torch.core.report import session_table
        return session_table(self._traces, by=by, metric=metric)

    def diff(self, label_a: str, label_b: str, by: str = "kind_link",
             top: Optional[int] = None, only_regressed: bool = False,
             as_json: bool = False) -> str:
        """Pairwise diff between two labels or fleet slices.

        Either side may be a trace label or a `host=00*,step=1` slice
        spec (see `parse_slice`): slice sides tree-merge their matching
        traces into one synthetic trace first, so "hosts 00x vs hosts
        01x" is one diff, not a quadratic pile of pairs.  `top` keeps
        only the N largest-|byte-delta| rows, `only_regressed` keeps
        NEW/GREW rows, and `as_json` returns the machine-readable
        payload (`diff.diff_json`, with a `slice` block naming the
        specs) instead of the rendered table.
        """
        from repro_torch.core.diff import diff_json, render_diff
        a, n_a = self._resolve(label_a)
        b, n_b = self._resolve(label_b)
        if as_json:
            extra = None
            if n_a is not None or n_b is not None:
                extra = {"a": {"spec": label_a,
                               "traces": 1 if n_a is None else n_a},
                         "b": {"spec": label_b,
                               "traces": 1 if n_b is None else n_b}}
            return json.dumps(diff_json(a, b, by=by, top=top,
                                        only_regressed=only_regressed,
                                        extra=extra),
                              indent=1)
        return render_diff(a, b, by=by, top=top,
                           only_regressed=only_regressed)

    # -- warehouse query layer -----------------------------------------------

    def select(self, host: Optional[str] = None, step: Optional[str] = None,
               op: Optional[str] = None, kind: Optional[str] = None
               ) -> "TraceSession":
        """The sub-session matching a warehouse slice.

        `host`/`step` filter whole traces on their label metadata
        (`label_meta`; shell globs, numeric steps match exactly).
        `op`/`kind` filter *rows* inside each surviving trace on the
        interned codes (`Categorical.mask_glob` — O(vocab) string work,
        one vectorized mask per column) *before* any rollup runs.
        Traces with no row filter are shared by reference, so slicing a
        memory-mapped session stays zero-copy.
        """
        out: List[Trace] = []
        for t in self._traces:
            meta = label_meta(t.label)
            if host is not None and not fnmatch.fnmatchcase(
                    str(meta.get("host", "")), host):
                continue
            if step is not None:
                st = meta.get("step")
                if st is None or not _step_match(st, step):
                    continue
            if op is not None or kind is not None:
                mask = np.ones(t.store.n, dtype=bool)
                if op is not None:
                    mask &= t.store.op_name.mask_glob(op)
                if kind is not None:
                    mask &= t.store.kind.mask_glob(kind)
                t = _trace_from_meta(_trace_meta(t), t.store.where(mask))
            out.append(t)
        sel = TraceSession(self.name, out)
        sel.ingest_report = self.ingest_report
        return sel

    def merged(self, label: str = "fleet", arity: int = 8,
               workers: int = 1) -> Trace:
        """All traces tree-merged into one synthetic fleet trace.

        Store rows concatenate in session order via
        `TraceStore.merge_tree` (identical to the flat merge, O(log n)
        reduction depth); scalars sum and op stats fold with
        `HloOpStats.merged`.  Mesh metadata comes from the first trace —
        a fleet dump shares one mesh by construction.  A single-trace
        session returns that trace's store unmerged (and uncopied).
        """
        if not self._traces:
            raise KeyError(
                f"session {self.name!r} has no traces to merge")
        store = TraceStore.merge_tree([t.store for t in self._traces],
                                      arity=arity, workers=workers)
        meta = _trace_meta(self._traces[0])
        meta["label"] = label
        meta["scalars"] = {
            k: float(sum(getattr(t, k) for t in self._traces))
            for k in _TRACE_SCALARS}
        meta["op_stats"] = dataclasses.asdict(
            HloOpStats.merged([t.op_stats for t in self._traces]))
        return _trace_from_meta(meta, store)

    def _resolve(self, label: str) -> Tuple[Trace, Optional[int]]:
        """A trace for a label *or* slice spec: (trace, n merged | None).

        A spec containing "=" selects+merges (raising `KeyError` when it
        matches nothing, same contract as an unknown label); a plain
        label passes through `get`.
        """
        if "=" in label:
            sel = self.select(**parse_slice(label))
            if not len(sel):
                raise KeyError(
                    f"slice {label!r} matches no traces in session "
                    f"{self.name!r} (have {self.labels()})")
            return sel.merged(label=label), len(sel)
        return self.get(label), None

    def query(self, host: Optional[str] = None, step: Optional[str] = None,
              op: Optional[str] = None, kind: Optional[str] = None,
              by: str = "kind_link") -> Dict[str, object]:
        """Aggregate a warehouse slice without merging or materializing.

        Filters with `select`, then folds the surviving stores through
        `IncrementalRollup` — O(unique labels) state, no concatenation —
        so querying a memory-mapped fleet session touches only the
        columns the rollup reads.  Returns the stable machine payload
        (`session query --json`): slice echo, per-trace rows, fleet
        totals, and the requested rollup.
        """
        from repro_torch.core.store import IncrementalRollup
        sel = self.select(host=host, step=step, op=op, kind=kind)
        roll = IncrementalRollup(by)
        for t in sel:
            roll.update(t.store)
        rows = roll.as_dict()
        totals = {m: float(sum(r[m] for r in rows.values()))
                  for m in ("bytes", "wire_bytes", "count", "time_s")}
        payload: Dict[str, object] = {
            "session": self.name,
            "slice": {"host": host, "step": step, "op": op, "kind": kind},
            "traces": sel.labels(),
            "sites": int(sum(t.store.n for t in sel)),
            "totals": totals,
            "rollup": {"by": by, "rows": rows},
        }
        if self.ingest_report is not None:
            degraded = self.ingest_report.degraded
            payload["ingest"] = {
                "records": len(self.ingest_report.records),
                "degraded": len(degraded),
                "degraded_hosts": sorted({r.host for r in degraded
                                          if r.host}),
            }
        return payload

    def report(self, label: Optional[str] = None, fmt: str = "json",
               fp=None, stream: bool = False, chunk_sites: int = 8192):
        """Render one trace (default: the first) as JSON or HTML.

        `label` may also be a `host=00*`-style slice spec: the matching
        traces tree-merge into one synthetic fleet trace first.  With
        `fp` set, writes to it — streamed through the chunked columnar
        emitters when `stream=True` (bounded memory at 1M+ sites).
        Without `fp`, returns the rendered string.
        """
        from repro_torch.core import report as report_mod
        if not self._traces:
            raise KeyError(f"session {self.name!r} has no traces to report")
        tr = self._resolve(label)[0] if label is not None else self._traces[0]
        mesh = MeshSpec(tr.mesh_shape, tr.mesh_axes)
        if fp is None:
            return report_mod.to_json(tr) if fmt == "json" \
                else report_mod.to_html(tr, mesh)
        if fmt == "json":
            if stream:
                report_mod.write_json(tr, fp, chunk_sites=chunk_sites)
            else:
                fp.write(report_mod.to_json(tr))
        else:
            if stream:
                report_mod.write_html(tr, mesh, fp)
            else:
                fp.write(report_mod.to_html(tr, mesh))
        fp.write("\n")
        return None

    # -- bulk ingest ---------------------------------------------------------

    @classmethod
    def from_captures(cls, name: str,
                      items: Sequence[Union[str, Tuple[str, str]]],
                      mesh: MeshSpec, *,
                      max_workers: Optional[int] = None,
                      errors: str = "raise",
                      retries: int = 1,
                      retry_backoff_s: float = 0.1,
                      timeout_s: Optional[float] = None) -> "TraceSession":
        """Ingest many capture dumps (`core.dump`) into one session, in
        parallel (the reference's `from_hlo`).

        `items` are either `(label, capture_text)` pairs or paths to
        capture files (label = file stem).  Each file is read in its own
        worker process; results come back as columnar stores.  Every
        capture's header mesh must be `mesh` (shape and axes), and its
        pricing (the H100 model on the job's links) is kept as written.
        Falls back to serial ingest when the *pool* is unavailable
        (restricted environments, spawn bootstrap failure, pool death) or
        for a single file.

        `errors` is the per-input failure policy:
          * `"raise"` (default) — a genuine per-file failure raises
            `IngestError` naming the offending input instead of silently
            re-running everything serially.  Zero overhead on clean
            inputs; the returned session still carries an all-ok
            `ingest_report`.
          * `"skip"` — failed inputs are retried (`retries` attempts
            with exponential backoff from `retry_backoff_s`, re-reading
            path inputs) then dropped; the session holds the survivors.
          * `"salvage"` — like skip, but a damaged capture is first
            re-read with salvage recovery
            (`dump.trace_from_capture(recover=True)`): its intact rows are
            kept as a partial trace, and only inputs that defeat even
            salvage (unreadable bytes, another mesh) are quarantined.

        Every input's outcome lands in `session.ingest_report`
        (an `IngestReport`, persisted through save/load), so a partial
        session is never silently partial.

        `timeout_s` bounds each worker's result: a hung worker kills the
        pool, and the stuck input plus everything still pending is
        retried serially under the same `errors` policy (quarantined if
        it fails again).
        """
        if errors not in ("raise", "skip", "salvage"):
            raise ValueError(f"errors must be 'raise', 'skip' or 'salvage', "
                             f"got {errors!r}")
        pool_files = max_workers is None or max_workers > 1
        if max_workers is None:
            max_workers = min(len(items), os.cpu_count() or 1)
        pool_files = pool_files and max_workers > 1 and len(items) > 1
        entries = _ingest_jobs(items, mesh, errors=errors, retries=retries,
                               backoff_s=retry_backoff_s)
        # input-order maps: results[i] -> Trace, recs[i] -> IngestRecord
        results: Dict[int, Trace] = {}
        recs: Dict[int, IngestRecord] = {
            i: rec for i, (_s, _it, job, rec) in enumerate(entries)
            if job is None}
        live = [(i, src, it, job)
                for i, (src, it, job, _rec) in enumerate(entries)
                if job is not None]
        pending = live      # the live subset to (re)run serially
        if pool_files:
            import concurrent.futures as cf
            import multiprocessing
            import pickle
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            from repro_torch.core.store import _SPAWN_PROBE_TIMEOUT_S

            # spawn, not fork: the parent often has torch loaded (and so
            # multiple live threads) by the time a sweep is ingested, and
            # forking a multithreaded process can deadlock workers.
            ex = None
            try:
                ex = ProcessPoolExecutor(
                    max_workers=max_workers,
                    mp_context=multiprocessing.get_context("spawn"))
                # no-op probe: where spawn cannot bootstrap workers the
                # map below hangs rather than raising, so pool *startup*
                # failure — and only that — is detected here and falls
                # back to serial ingest
                ex.submit(int).result(timeout=_SPAWN_PROBE_TIMEOUT_S)
            except Exception:
                if ex is not None:
                    ex.shutdown(wait=False, cancel_futures=True)
                ex = None
            if ex is not None:
                futs = [ex.submit(_ingest_one, job)
                        for _i, _s, _it, job in live]
                pending = []
                dead = False
                try:
                    for (i, src, it, job), fut in zip(live, futs):
                        if dead:
                            pending.append((i, src, it, job))
                            continue
                        try:
                            results[i] = fut.result(timeout=timeout_s)
                            recs[i] = IngestRecord(src, job[0])
                        except (BrokenProcessPool, pickle.PicklingError):
                            # the pool died, not the input: retry serially
                            dead = True
                            pending.append((i, src, it, job))
                        except cf.TimeoutError:
                            # hung worker: kill the pool; this input and
                            # everything still pending retries serially
                            # (quarantined under skip/salvage if it fails
                            # again)
                            dead = True
                            pending.append((i, src, it, job))
                        except Exception as e:
                            if errors == "raise":
                                raise IngestError(
                                    f"failed to ingest {src!r}: {e}") from e
                            tr, rec = _recover_one(src, it, job, e, errors,
                                                   retries, retry_backoff_s)
                            if tr is not None:
                                results[i] = tr
                            recs[i] = rec
                finally:
                    ex.shutdown(wait=False, cancel_futures=True)
        for i, src, it, job in pending:
            try:
                results[i] = _ingest_one(job)
                recs[i] = IngestRecord(src, job[0])
            except Exception as e:
                if errors == "raise":
                    raise IngestError(f"failed to ingest {src!r}: {e}") from e
                tr, rec = _recover_one(src, it, job, e, errors,
                                       retries, retry_backoff_s)
                if tr is not None:
                    results[i] = tr
                recs[i] = rec
        report = IngestReport(errors=errors,
                              records=[recs[i] for i in sorted(recs)])
        sess = cls(name, [results[i] for i in sorted(results)])
        sess.ingest_report = report
        return sess

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, *, compress: bool = True,
             workers: Optional[int] = None) -> str:
        """Persist to `path` (.json or .npz, by extension; default .json).

        Writes are atomic (same-directory temp file + `os.replace`): a
        concurrent reader sees the previous complete file or the new one,
        never a torn intermediate.  Returns the path actually
        written; `load` applies the same extension defaulting, so
        `load(p)` works for any extensionless `p` passed to `save`.

        The npz container is `persist.write_npz`: byte-deterministic
        (same session -> same file) and DEFLATE'd across a thread pool
        (`workers`; zlib releases the GIL) while one writer assembles
        the archive — the `savez_compressed` single-thread bottleneck
        is gone.  `compress=False` stores members raw, the layout
        `load(mmap=True)` opens zero-copy.
        """
        rep = self.ingest_report.to_dict() if self.ingest_report else None
        if path.endswith(".npz"):
            arrs: Dict[str, np.ndarray] = {}
            for i, t in enumerate(self._traces):
                arrs.update(t.store.npz_arrays(prefix=f"t{i}_"))
            side = {"name": self.name,
                    "traces": [_trace_meta(t) for t in self._traces]}
            if rep is not None:
                side["ingest_report"] = rep
            arrs["session"] = np.array(json.dumps(side))
            with atomic_open(path, "wb") as f:
                write_npz(f, arrs, compress=compress, workers=workers)
            return path
        if not path.endswith(".json"):
            path += ".json"
        payload = {"name": self.name,
                   "traces": [trace_to_dict(t) for t in self._traces]}
        if rep is not None:
            payload["ingest_report"] = rep
        with atomic_open(path, "w") as f:
            json.dump(payload, f, separators=(",", ":"),
                      sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str, *, mmap: bool = False) -> "TraceSession":
        """Load a saved session; `mmap=True` opens an npz zero-copy.

        The mmap path requires an *uncompressed* archive (`save` with
        `compress=False`): columns
        adopt read-only memory maps lazily (`TraceStore.from_npz_arrays
        (lazy=True)`), so a 10M-site session opens without
        materializing row data — pages fault in as queries touch them,
        and any mutation (`append`) copies instead of writing through.
        Raises `ValueError` for a compressed archive or a non-npz path.
        """
        if not path.endswith((".json", ".npz")):
            path += ".json"    # mirror save's extension defaulting
        if path.endswith(".npz"):
            if mmap:
                if not os.path.exists(path):
                    raise FileNotFoundError(path)
                marrs = open_npz_mmap(path)
                side = json.loads(str(marrs["session"]))
                traces = [
                    _trace_from_meta(
                        meta, TraceStore.from_npz_arrays(
                            marrs, prefix=f"t{i}_", lazy=True))
                    for i, meta in enumerate(side["traces"])]
            else:
                with np.load(path) as arrs:
                    side = json.loads(str(arrs["session"]))
                    traces = [
                        _trace_from_meta(
                            meta, TraceStore.from_npz_arrays(
                                arrs, prefix=f"t{i}_"))
                        for i, meta in enumerate(side["traces"])]
            sess = cls(side["name"], traces)
            if side.get("ingest_report") is not None:
                sess.ingest_report = IngestReport.from_dict(
                    side["ingest_report"])
            return sess
        if mmap:
            raise ValueError(
                f"mmap load requires an uncompressed .npz session, "
                f"got {path!r}")
        with open(path) as f:
            payload = json.load(f)
        sess = cls(payload["name"],
                   [trace_from_dict(d) for d in payload["traces"]])
        if payload.get("ingest_report") is not None:
            sess.ingest_report = IngestReport.from_dict(
                payload["ingest_report"])
        return sess


# --------------------------------------------------------------------------
# demo session: the "Allreduce across MPI libraries / UCX settings" shape
# --------------------------------------------------------------------------

def demo_session(n_sites: int = 2000, seed: int = 0) -> TraceSession:
    """Three mesh/config variants of the same synthetic workload.

    The knobs mirror the paper's comparison dimensions: mesh layout
    (NUMA-binding analogue), rendezvous threshold (UCX setting analogue),
    and axis bias (library algorithm-choice analogue).
    """
    import dataclasses as dc

    from repro_torch.core.synth import synthetic_trace
    from repro_torch.core.topology import H100

    sess = TraceSession("demo-allreduce-sweep")
    sess.add(synthetic_trace(
        "dp8-baseline", MeshSpec((8,), ("data",)), H100,
        n_sites=n_sites, seed=seed))
    sess.add(synthetic_trace(
        "dp2xtp4", MeshSpec((2, 4), ("data", "model")), H100,
        n_sites=n_sites, seed=seed, axis_weights=(2.0, 1.0)))
    sess.add(synthetic_trace(
        "pod2xdp4-rndv64k", MeshSpec((2, 4), ("pod", "data")),
        dc.replace(H100, rndv_threshold=1 << 16),
        n_sites=n_sites, seed=seed, axis_weights=(1.0, 3.0)))
    return sess


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.session",
        description="multi-trace session workflows")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo", help="build, save, reload and compare a "
                                    "3-config synthetic sweep")
    p.add_argument("--out", default="results/session_demo.json",
                   help="save path (default results/session_demo.json)")
    p.add_argument("--format", choices=("json", "npz"), default=None,
                   help="force the session format, overriding the --out "
                        "extension")
    p.add_argument("--sites", type=int, default=2000,
                   help="synthetic collective sites per trace "
                        "(default 2000)")

    p = sub.add_parser(
        "ingest",
        help="read capture dumps into a session (parallel ingest)",
        description="Read capture dumps (.jsonl, written by running ranks) "
                    "into one saved session. "
                    "Exit codes: with --errors=raise (default), 0 on "
                    "success and 2 on the first bad input; with "
                    "--errors=skip|salvage, 0 only when every input "
                    "ingested cleanly, 3 when any input was skipped, "
                    "salvaged or quarantined (the session is still "
                    "written with the survivors and carries the ingest "
                    "report), and 2 for hard failures (unwritable "
                    "output, bad arguments).")
    p.add_argument("out", help="output session path (.json or .npz)")
    p.add_argument("files", nargs="+", help="capture dump files (.jsonl)")
    p.add_argument("--mesh", default="2,4",
                   help="mesh shape, comma-separated (default 2,4); every "
                        "capture's header must match")
    p.add_argument("--axes", default="data,model",
                   help="mesh axis names, comma-separated")
    p.add_argument("--workers", type=int, default=None,
                   help="worker processes for the per-file fan-out "
                        "(default: one per file, capped at CPU count; "
                        "1 = serial)")
    p.add_argument("--errors", choices=("raise", "skip", "salvage"),
                   default="raise",
                   help="per-input failure policy: raise (default) aborts "
                        "with exit 2 on the first bad input; skip retries "
                        "then drops bad inputs; salvage additionally "
                        "recovers the intact rows of damaged captures as "
                        "partial traces. skip/salvage exit 0 on full "
                        "success, 3 when anything was degraded")
    p.add_argument("--retries", type=int, default=1,
                   help="re-attempts per failed input, with exponential "
                        "backoff (default 1; skip/salvage only)")
    p.add_argument("--retry-backoff", type=float, default=0.1,
                   help="initial retry backoff in seconds, doubling per "
                        "attempt (default 0.1)")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-file worker timeout in seconds: a hung "
                        "worker kills the pool and the file is retried "
                        "serially, then quarantined (default: none)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the machine-readable ingest report "
                        "(every input's outcome) to stdout")
    p.add_argument("--no-compress", action="store_true",
                   help="store npz members raw instead of DEFLATE'd — "
                        "the layout `query`/`diff --mmap` opens "
                        "zero-copy (larger file, instant open)")

    p = sub.add_parser("watch", help="tail a capture dump directory: ingest "
                                     "new/changed files, keep rolling "
                                     "reports fresh (live profiling)")
    p.add_argument("root", help="dump directory to watch")
    p.add_argument("--pattern", default="*.jsonl",
                   help="glob for dump files inside ROOT (default *.jsonl)")
    p.add_argument("--mesh", default="2,4",
                   help="mesh shape, comma-separated (default 2,4)")
    p.add_argument("--axes", default="data,model",
                   help="mesh axis names, comma-separated")
    p.add_argument("--out", default=None,
                   help="rolling session save path (.json or .npz)")
    p.add_argument("--report-json", default=None,
                   help="rolling JSON report path (first trace)")
    p.add_argument("--report-html", default=None,
                   help="rolling HTML report path (first trace)")
    p.add_argument("--summary", default=None,
                   help="rolling machine summary JSON (aggregates + "
                        "findings)")
    p.add_argument("--settle", type=float, default=0.25,
                   help="seconds a file's size+mtime must hold still "
                        "before it is ingested (default 0.25)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between polls (default 1.0)")
    p.add_argument("--once", action="store_true",
                   help="ingest until the directory is quiescent, then "
                        "exit (CI/testing mode)")
    p.add_argument("--fail-on", choices=("critical", "warn", "info", "never"),
                   default="never",
                   help="print alerts and exit 1 when any finding reaches "
                        "this severity (default: never); without alerts "
                        "the daemon exits 3 when any input was salvaged "
                        "or quarantined, else 0")
    p.add_argument("--max-rounds", type=int, default=None,
                   help="stop after this many polls (default: unbounded)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-round progress lines")
    p.add_argument("--errors", choices=("raise", "skip", "salvage"),
                   default="salvage",
                   help="per-file failure policy: salvage (default) "
                        "recovers the intact rows of damaged dumps, skip "
                        "quarantines them whole, raise crashes the daemon "
                        "(strict mode)")
    p.add_argument("--max-retries", type=int, default=3,
                   help="same-signature re-attempts (with exponential "
                        "backoff) before a failing file's quarantine "
                        "seals until the file changes (default 3)")
    p.add_argument("--retry-backoff", type=float, default=0.5,
                   help="initial quarantine retry backoff in seconds, "
                        "doubling per failure (default 0.5)")
    p.add_argument("--checkpoint", default=None,
                   help="crash-resume checkpoint path (.npz): atomically "
                        "rewritten after every state-changing poll; a "
                        "daemon restarted on the same checkpoint resumes "
                        "without re-reading already-ingested files")

    p = sub.add_parser("show", help="per-trace summaries of a saved session")
    p.add_argument("path", help="saved session (.json or .npz)")

    p = sub.add_parser("table", help="n-way comparison table")
    p.add_argument("path", help="saved session (.json or .npz)")
    p.add_argument("--by", choices=("kind_link", "semantic", "site"),
                   default="kind_link",
                   help="rollup key; 'site' breaks out per compiled "
                        "callsite (op_name x kind x axes)")
    p.add_argument("--metric", choices=("bytes", "time", "count"),
                   default="bytes",
                   help="cell metric: operand bytes, modeled est time, "
                        "or collective count per step (default bytes)")

    p = sub.add_parser("diff", help="pairwise deep-dive between two labels "
                                    "or fleet slices")
    p.add_argument("path", help="saved session (.json or .npz)")
    p.add_argument("label_a", help="baseline trace label, or a fleet slice "
                                   "spec like host=00*,step=1 (matching "
                                   "traces tree-merge into one side)")
    p.add_argument("label_b", help="candidate trace label or slice spec "
                                   "(deltas are B-A)")
    p.add_argument("--by", choices=("kind_link", "semantic", "site"),
                   default="kind_link",
                   help="alignment key; 'site' aligns per compiled callsite "
                        "(op_name x kind x axes)")
    p.add_argument("--top", type=int, default=None,
                   help="keep only the N largest-|byte-delta| rows")
    p.add_argument("--only-regressed", action="store_true",
                   help="keep only rows that grew or are new in B")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a machine-readable JSON diff instead of the "
                        "rendered table")
    p.add_argument("--mmap", action="store_true",
                   help="open an uncompressed npz session zero-copy "
                        "(saved with compress=False)")

    p = sub.add_parser(
        "query",
        help="filter a saved session by host/step/op/kind and aggregate "
             "the slice (warehouse view)",
        description="Select traces by host/step (parsed from "
                    "host012_step003-style labels) and rows by op/kind "
                    "globs, then aggregate the slice without merging. "
                    "Exit codes: 0 on success (an empty slice is a "
                    "valid, empty answer), 2 on input errors — same "
                    "contract as detect/lint.")
    p.add_argument("path", help="saved session (.json or .npz)")
    p.add_argument("--host", default=None,
                   help="host id glob (e.g. 00*), matched against the "
                        "trace label's hostNNN marker")
    p.add_argument("--step", default=None,
                   help="step index (numeric, exact) or glob against the "
                        "label's stepNNN marker")
    p.add_argument("--op", default=None,
                   help="op_name glob, filters rows on interned codes")
    p.add_argument("--kind", default=None,
                   help="collective kind glob (e.g. all-reduce*)")
    p.add_argument("--by", choices=("kind_link", "semantic", "site"),
                   default="kind_link",
                   help="rollup key for the slice aggregate "
                        "(default kind_link)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the stable machine payload instead of text")
    p.add_argument("--mmap", action="store_true",
                   help="open an uncompressed npz session zero-copy "
                        "(saved with compress=False)")

    p = sub.add_parser("lint", help="static collective-correctness analysis "
                                    "(commcheck) over sessions or capture dumps")
    p.add_argument("paths", nargs="+",
                   help="saved sessions (.json/.npz) or capture dumps (.jsonl)")
    p.add_argument("--mesh", default="2,4",
                   help="mesh shape for capture inputs, comma-separated")
    p.add_argument("--axes", default="data,model",
                   help="mesh axis names for capture inputs, comma-separated")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the stable machine schema (same as "
                        "`detect --json`) instead of text")
    p.add_argument("--fail-on", choices=("critical", "warn", "info", "never"),
                   default="critical",
                   help="exit 1 when any finding reaches this severity "
                        "(default: critical)")

    p = sub.add_parser("detect", help="dynamic performance detectors over "
                                      "a saved session")
    p.add_argument("path", help="saved session (.json or .npz)")
    p.add_argument("label", nargs="?", default=None,
                   help="trace label (default: all traces)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the stable machine schema (same as "
                        "`lint --json`) instead of text")
    p.add_argument("--fail-on", choices=("critical", "warn", "info", "never"),
                   default="never",
                   help="exit 1 when any finding reaches this severity "
                        "(default: never — detectors are advisory)")

    p = sub.add_parser("report", help="render one trace of a session as "
                                      "JSON or a self-contained HTML page",
                       epilog="the report carries the full per-trace "
                              "rollups and findings; for interactive "
                              "per-callsite views use `table --by site` "
                              "and `diff --by site`")
    p.add_argument("path", help="saved session (.json or .npz)")
    p.add_argument("label", nargs="?", default=None,
                   help="trace label or fleet slice spec like host=00* "
                        "(default: the session's first trace)")
    p.add_argument("--format", choices=("json", "html"), default="json",
                   help="output format (default json)")
    p.add_argument("--out", default=None, help="output file (default stdout)")
    p.add_argument("--stream", action="store_true",
                   help="stream through the chunked columnar emitters "
                        "(bounded memory for very large traces)")
    p.add_argument("--chunk-sites", type=int, default=8192,
                   help="sites per chunk when streaming (default 8192)")

    p = sub.add_parser(
        "whatif",
        help="hardwareless config sweep: re-price a trace under "
             "counterfactual meshes/thresholds and rank the savings",
        description="Re-annotate one trace under a grid of what-if "
                    "scenarios (mesh axis permutations, rendezvous "
                    "threshold tiers, link bandwidth/latency tiers) "
                    "without re-capture or hardware, and rank scenarios "
                    "by estimated step time saved vs the baseline. "
                    "Exit codes: 0 on success, 2 on input errors.")
    p.add_argument("path", help="saved session (.json/.npz) or capture "
                                "dump (.jsonl)")
    p.add_argument("label", nargs="?", default=None,
                   help="trace label (default: the session's first trace; "
                        "ignored for capture inputs)")
    p.add_argument("--mesh", default="2,4",
                   help="mesh shape for capture inputs, comma-separated "
                        "(saved sessions carry their own mesh)")
    p.add_argument("--axes", default="data,model",
                   help="mesh axis names for capture inputs, comma-separated")
    p.add_argument("--top", type=int, default=5,
                   help="top per-site savings kept per scenario "
                        "(default 5)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable sweep (baseline + "
                        "every scenario, ranked by time saved) instead "
                        "of the table")

    args = ap.parse_args(argv)

    if args.cmd == "demo":
        out = args.out
        if args.format and not out.endswith("." + args.format):
            out = os.path.splitext(out)[0] + "." + args.format
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        sess = demo_session(n_sites=args.sites)
        path = sess.save(out)
        loaded = TraceSession.load(path)
        print(f"session '{loaded.name}': {len(loaded)} traces -> {path} "
              f"({os.path.getsize(path)//1024} KB)")
        _print_totals(loaded)
        print()
        print(loaded.table())
        print()
        print(loaded.table(by="semantic", metric="time"))
        return 0

    if args.cmd == "ingest":
        mesh = _mesh_arg(args)
        if mesh is None:
            return 2
        try:
            sess = TraceSession.from_captures(
                os.path.splitext(os.path.basename(args.out))[0],
                args.files, mesh, max_workers=args.workers,
                errors=args.errors, retries=args.retries,
                retry_backoff_s=args.retry_backoff, timeout_s=args.timeout)
        except FileNotFoundError as e:
            print(f"error: no such file: {e.filename}", file=sys.stderr)
            return 2
        except IngestError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        path = sess.save(args.out, compress=not args.no_compress)
        rep = sess.ingest_report
        if args.as_json:
            print(json.dumps(rep.to_dict(), indent=1))
        else:
            print(f"session '{sess.name}': ingested {len(sess)} traces "
                  f"-> {path}")
            if len(sess):
                _print_totals(sess)
        for r in rep.degraded:
            print(f"ingest: [{r.status}] {r.source} "
                  f"({r.attempts} attempt(s)): {r.error}", file=sys.stderr)
        return 3 if rep.degraded else 0

    if args.cmd == "watch":
        from repro_torch.core.watch import WatchConfig, WatchDaemon
        mesh = _mesh_arg(args)
        if mesh is None:
            return 2
        if not os.path.isdir(args.root):
            print(f"error: no such directory: {args.root}", file=sys.stderr)
            return 2
        for out in (args.out, args.report_json, args.report_html,
                    args.summary, args.checkpoint):
            if out:
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        cfg = WatchConfig(
            root=args.root, mesh=mesh,
            pattern=args.pattern, out=args.out,
            report_json=args.report_json, report_html=args.report_html,
            summary=args.summary, settle_s=args.settle,
            interval_s=args.interval, once=args.once,
            fail_on=args.fail_on, max_rounds=args.max_rounds,
            quiet=args.quiet, errors=args.errors,
            max_retries=args.max_retries,
            retry_backoff_s=args.retry_backoff, checkpoint=args.checkpoint)
        return WatchDaemon(cfg).run()

    if args.cmd == "lint":
        from repro_torch.core import commcheck
        mesh = _mesh_arg(args)
        if mesh is None:
            return 2
        results = []
        for path in args.paths:
            try:
                for t, m in _input_traces(path, mesh):
                    results.append((path, t.label, commcheck.check_trace(t, m)))
            except FileNotFoundError:
                print(f"error: no such file: {path}", file=sys.stderr)
                return 2
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                print(f"error: cannot lint {path} ({e!r})", file=sys.stderr)
                return 2
        return _emit_findings(results, args.as_json, args.fail_on)

    if args.cmd == "whatif":
        from repro_torch.core import whatif as whatif_mod
        try:
            if args.path.endswith(_SESSION_EXTS):
                sess = TraceSession.load(args.path)
                if not len(sess):
                    print(f"error: session {sess.name!r} has no traces",
                          file=sys.stderr)
                    return 2
                tr = sess.get(args.label) if args.label else list(sess)[0]
            else:
                mesh = _mesh_arg(args)
                if mesh is None:
                    return 2
                (tr, _m), = _input_traces(args.path, mesh)
        except FileNotFoundError:
            print(f"error: no such file: {args.path}", file=sys.stderr)
            return 2
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot sweep {args.path} ({e!r})",
                  file=sys.stderr)
            return 2
        mesh = MeshSpec(tr.mesh_shape, tr.mesh_axes)
        results = whatif_mod.sweep(tr.store, mesh, top=args.top)
        if args.as_json:
            print(json.dumps(
                whatif_mod.sweep_to_dict(results, tr.label, mesh), indent=1))
        else:
            print(whatif_mod.render_sweep(results, tr.label))
        return 0

    try:
        sess = TraceSession.load(args.path,
                                 mmap=getattr(args, "mmap", False))
    except FileNotFoundError:
        print(f"error: no such session file: {args.path}", file=sys.stderr)
        return 2
    except (KeyError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {args.path} is not a saved session ({e!r})",
              file=sys.stderr)
        return 2
    if args.cmd == "show":
        print(f"session '{sess.name}': {len(sess)} traces")
        _print_totals(sess)
    elif args.cmd == "table":
        print(sess.table(by=args.by, metric=args.metric))
    elif args.cmd == "diff":
        try:
            print(sess.diff(args.label_a, args.label_b, by=args.by,
                            top=args.top, only_regressed=args.only_regressed,
                            as_json=args.as_json))
        except (KeyError, ValueError) as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    elif args.cmd == "query":
        try:
            payload = sess.query(host=args.host, step=args.step,
                                 op=args.op, kind=args.kind, by=args.by)
        except ValueError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(payload, indent=1))
        else:
            sl = payload["slice"]
            spec = ",".join(f"{k}={v}" for k, v in sl.items()
                            if v is not None) or "(all)"
            print(f"session '{payload['session']}' slice {spec}: "
                  f"{len(payload['traces'])} trace(s), "
                  f"{payload['sites']} sites")
            tot = payload["totals"]
            print(f"  totals: {tot['bytes']/1e9:.3f} GB, "
                  f"{tot['wire_bytes']/1e9:.3f} wire GB, "
                  f"{tot['count']:.0f} collectives/step, "
                  f"{tot['time_s']*1e3:.3f} est ms")
            rows = payload["rollup"]["rows"]
            for lbl in sorted(rows, key=lambda k: -rows[k]["bytes"]):
                r = rows[lbl]
                print(f"  {lbl:40s} {r['bytes']/1e9:9.3f} GB "
                      f"{r['count']:8.0f}/step {r['time_s']*1e3:9.3f} ms")
    elif args.cmd == "detect":
        from repro_torch.core import detect as detect_mod
        try:
            traces = [sess.get(args.label)] if args.label else list(sess)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
        results = [(args.path, t.label, detect_mod.run_all(t))
                   for t in traces]
        return _emit_findings(results, args.as_json, args.fail_on)
    elif args.cmd == "report":
        # resolve the label before touching the output path, so a typo'd
        # label can't truncate a previous report
        try:
            label = args.label if args.label is not None else \
                (sess.labels() or [None])[0]
            if label is None:
                raise KeyError(f"session {sess.name!r} has no traces "
                               f"to report")
            sess._resolve(label)
        except (KeyError, ValueError) as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            # atomic: a concurrent reader (CI artifact collection) never
            # sees a half-written report
            with atomic_open(args.out, "w") as fp:
                sess.report(label, fmt=args.format, fp=fp,
                            stream=args.stream,
                            chunk_sites=args.chunk_sites)
            print(f"wrote {args.format} report -> {args.out} "
                  f"({os.path.getsize(args.out)//1024} KB)")
        else:
            sess.report(label, fmt=args.format, fp=sys.stdout,
                        stream=args.stream, chunk_sites=args.chunk_sites)
    return 0


_SESSION_EXTS = (".json", ".npz")
_CAPTURE_EXT = ".jsonl"


def _mesh_arg(args) -> Optional[MeshSpec]:
    """`--mesh`/`--axes` as a MeshSpec; None (after the error line) when
    their ranks differ."""
    shape = tuple(int(x) for x in args.mesh.split(","))
    axes = tuple(args.axes.split(","))
    if len(shape) != len(axes):
        print("error: --mesh and --axes must have the same rank",
              file=sys.stderr)
        return None
    return MeshSpec(shape, axes)


def _input_traces(path: str, mesh: MeshSpec):
    """The (trace, mesh to read it on) pairs of a `lint`/`whatif` input: a
    saved session's traces on their own meshes, or a capture dump read
    strictly on `mesh` (the reference's HLO text file's place).  Any other
    file raises ValueError (exit 2): the port reads no HLO text."""
    if path.endswith(_SESSION_EXTS):
        return [(t, None) for t in TraceSession.load(path)]
    if not path.endswith(_CAPTURE_EXT):
        raise ValueError(f"{path!r} is neither a saved session (.json or .npz) "
                         f"nor a capture dump ({_CAPTURE_EXT}); HLO text input "
                         f"is not supported")
    from repro_torch.core.dump import read_capture, trace_from_capture
    label = os.path.splitext(os.path.basename(path))[0]
    return [(trace_from_capture(read_capture(path), mesh, label=label), mesh)]


def _emit_findings(results, as_json: bool, fail_on: str) -> int:
    """Shared `lint`/`detect` output: one stable schema, one exit policy.

    `results` is a list of (source path, trace label, findings).  Returns
    1 when any finding reaches the `fail_on` severity, else 0.
    """
    from repro_torch.core.detect import SEVERITY_RANK
    if as_json:
        print(json.dumps([
            {"source": src, "trace": lbl,
             "findings": [f.to_dict() for f in fs]}
            for src, lbl, fs in results], indent=1))
    else:
        for src, lbl, fs in results:
            print(f"{src} :: {lbl}: {len(fs)} finding(s)")
            for f in fs:
                where = f" @ {f.site}" if f.site else ""
                print(f"  [{f.severity}] {f.detector}{where}: {f.message}")
    if fail_on == "never":
        return 0
    worst = min((SEVERITY_RANK.get(f.severity, 99)
                 for _src, _lbl, fs in results for f in fs), default=99)
    return 1 if worst <= SEVERITY_RANK[fail_on] else 0


def _print_totals(sess: TraceSession) -> None:
    rows = sess.totals()
    print(f"  {'label':24s} {'sites':>7s} {'coll/step':>10s} {'GB':>9s} "
          f"{'wireGB':>9s} {'est_ms':>9s} {'ovl_ms':>9s}")
    for r in rows:
        print(f"  {r['label']:24s} {r['sites']:7d} "
              f"{int(r['collectives_per_step']):10d} "
              f"{r['collective_gb']:9.3f} {r['wire_gb']:9.3f} "
              f"{r['est_ms']:9.3f} {r['overlapped_ms']:9.3f}")


if __name__ == "__main__":
    raise SystemExit(_main())
