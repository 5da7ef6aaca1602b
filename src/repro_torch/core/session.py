"""TraceSession — named multi-trace collections with save/load + comparison
(a copy of the reference's `core/session.py`).

The paper's headline experiments are *comparisons across runs*: the same
Allreduce workload under different MPI libraries, UCX settings, and NUMA
bindings.  A `TraceSession` makes that shape first-class: collect traces
from several configurations (the port's captures, `core.trace_step`),
persist them as one artifact (compact JSON or compressed npz of the
columnar stores), and render n-way comparison views.

The file format is the reference's: a session saved by either package
loads in the other, with the same columns and scalars.  The reference's
HLO-text inputs are cut, since the port captures its traces and parses no
HLO: its `hlo_parser.AUTO_SHARD_BYTES` import (reference `session.py:104`)
and its `tracer.trace_from_hlo` calls (`:316`, `:401`, `:1317`, `:1349`),
and with them `TraceSession.from_hlo` and its ingest pipeline, the
`ingest` and `watch` commands (`watch.py`), and the HLO-file inputs of
`lint` and `whatif`.  A saved session's `ingest_report` (the reference's
per-file ingest provenance) is kept through load and save.

CLI:
    python -m repro_torch.core.session demo  [--out PATH] [--format json|npz]
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
    python -m repro_torch.core.session lint  PATH [PATH ...] [--json] \\
                                        [--fail-on critical|warn|info|never]
    python -m repro_torch.core.session detect PATH [LABEL] [--json] \\
                                        [--fail-on critical|warn|info|never]
    python -m repro_torch.core.session whatif PATH [LABEL] [--top N] [--json]

`lint` runs the static analyzer (`commcheck`) over saved sessions
(.json/.npz); `detect` runs the dynamic detectors over a saved session.
Both emit the same stable finding schema under --json and exit 1 when any
finding reaches the --fail-on severity (default: critical for lint, never
for detect), 2 on input errors.

`whatif` is the hardwareless config sweep (`repro_torch.core.whatif`): it
re-prices one trace of a saved session under a grid of counterfactual
scenarios — mesh axis permutations, rendezvous-threshold tiers, NVLink and
InfiniBand bandwidth/latency tiers — by re-running the columnar annotation
pass (no re-capture, no hardware), and ranks the scenarios by estimated
step time saved.  Exits 0 on success, 2 on input errors.

`query` is the warehouse slice view: filter the session's traces by
host/step (parsed from trace labels, `host012_step003`-style) and its
rows by op/kind globs, then aggregate the slice — without merging or
materializing anything.  `diff` and `report` accept the same slice
specs (`host=00*,step=1`) in place of a trace label: matching traces
tree-merge into one side of the comparison.  `--mmap` opens an
*uncompressed* npz (`TraceSession.save(..., compress=False)`) zero-copy,
so fleet-scale sessions slice without loading; exit codes follow
`detect`/`lint` (0 ok, 2 input errors).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import re
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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
# ingest provenance — the reference's bulk HLO ingest records it in saved
# sessions; the port keeps it through load and save
# --------------------------------------------------------------------------

@dataclasses.dataclass
class IngestRecord:
    """Per-input provenance of one reference `from_hlo` ingest.

    `status` is the outcome class:
      * `ok`          — parsed cleanly (possibly after retries);
      * `salvaged`    — strict parse failed, salvage parsing recovered a
        partial trace (`salvage` holds the `SalvageReport` dict);
      * `skipped`     — failed under `errors="skip"`, input excluded;
      * `quarantined` — failed even recovery (unreadable bytes, hung
        worker that also failed serially), input excluded.
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

    Persisted with the session, so a partial session carries the
    provenance of what was skipped, salvaged, or quarantined.
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


class TraceSession:
    """An ordered, label-addressed collection of traces."""

    def __init__(self, name: str, traces: Optional[Sequence[Trace]] = None):
        self.name = name
        # provenance of the bulk ingest that built this session (the
        # reference's `from_hlo`; persisted through save/load); None for
        # captured, hand-built or legacy-loaded sessions
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
                                    "(commcheck) over saved sessions")
    p.add_argument("paths", nargs="+", help="saved sessions (.json/.npz)")
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
    p.add_argument("path", help="saved session (.json/.npz)")
    p.add_argument("label", nargs="?", default=None,
                   help="trace label (default: the session's first trace)")
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

    if args.cmd == "lint":
        from repro_torch.core import commcheck
        results = []
        for path in args.paths:
            try:
                _require_session_path(path)
                for t in TraceSession.load(path):
                    results.append((path, t.label, commcheck.check_trace(t)))
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
            _require_session_path(args.path)
            sess = TraceSession.load(args.path)
            if not len(sess):
                print(f"error: session {sess.name!r} has no traces",
                      file=sys.stderr)
                return 2
            tr = sess.get(args.label) if args.label else list(sess)[0]
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


def _require_session_path(path: str) -> None:
    """`lint` and `whatif` read saved sessions only: the reference's HLO-text
    inputs are not ported (raises ValueError, exit 2)."""
    if not path.endswith((".json", ".npz")):
        raise ValueError(f"{path!r} is not a saved session (.json or .npz); "
                         f"HLO text input is not supported")


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
