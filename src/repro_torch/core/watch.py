"""Live profiling — tail a capture-dump directory, ingest deltas, keep
rolling aggregates fresh (a copy of the reference's `core/watch.py`).

The batch workflow (write each step's capture, `session ingest`, `session
report`) answers "what did that run do?".  This module answers the live
question — "what is the run doing *now*?" — the way the paper's daemon
mode does: a poller watches the directory running ranks write their
capture dumps into (`core.dump.write_capture`, one file a rank and step:
the port's counterpart of the modules a compiler dumps), ingests each file
once it has settled, and folds it into streaming state:

  * a rolling `TraceStore` grown in place with `TraceStore.append`,
  * `IncrementalRollup`s for the Table II traffic-class aggregates,
  * `detect.DetectorState` (dynamic detectors) sufficient statistics,
  * per-file `commcheck` findings (channel ids are scoped to one program,
    so the static analyzer runs per dump file — folding all files into
    one `CommcheckState` would invent cross-file channel collisions; that
    streaming state is for chunks of a single capture),

so every poll re-renders fresh reports in O(delta) work and O(unique
keys) memory, never re-reading old files.  Outputs (session save,
report JSON/HTML, summary JSON) are all written through
`persist.atomic_open`, so the consumers the daemon exists for — a
browser auto-reloading the HTML, CI collecting artifacts mid-run —
never observe a torn file.

A file is re-ingested when its (size, mtime) signature changes; since
streaming state cannot *subtract* a stale contribution, a changed file
triggers a rebuild from the retained per-file traces (rare; new files
are the hot path and stay incremental).

`run(once=True)` ingests until the directory is quiescent and exits —
the CI/testing mode; the equivalence contract is that its report output
is byte-identical to `session ingest` + `session report` over the final
directory contents.

Fault tolerance: a fleet's dump directory contains partially-written,
truncated and corrupted captures as a matter of course, so the daemon
never lets one bad file kill the loop.  A failed ingest is quarantined
with backoff-limited same-signature retries (sealed until the file
changes once exhausted); under the default `errors="salvage"` policy a
damaged capture's intact rows are recovered as a partial trace first.
Every outcome lands in a provenance ledger surfaced through
`summary()["ingest"]` and `session().ingest_report`.  With
`WatchConfig.checkpoint` set, the full fold state (retained traces,
watcher signatures, quarantine, ledger) is atomically re-persisted
after every state-changing poll, and a daemon restarted on the same
checkpoint resumes without re-reading already-ingested files — kill -9
at any instant loses at most the poll in flight.

The daemon touches no device: it reads files and folds numpy columns.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import commcheck, detect
from repro_torch.core.events import HloOpStats, Trace
from repro_torch.core.persist import atomic_open
from repro_torch.core.store import IncrementalRollup, TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec

Sig = Tuple[int, float]     # (size, mtime) file signature


class DirWatcher:
    """Poll-based new/changed-file detection over one dump directory.

    A file is *ready* when its (size, mtime) signature is unchanged
    across two consecutive polls AND its mtime is at least `settle_s`
    old — a writer mid-stream (a rank still writing its capture) fails
    both tests, so partially-written files are never handed to the
    reader.  A previously-ingested path whose signature changes
    later becomes ready again (changed-file re-ingest).
    """

    def __init__(self, root: str, pattern: str = "*.jsonl",
                 settle_s: float = 0.25):
        self.root = root
        self.pattern = pattern
        self.settle_s = settle_s
        self._last: Dict[str, Sig] = {}
        self._ingested: Dict[str, Sig] = {}
        # settle clock per signature: the raw mtime, clamped to the poll
        # time that first observed the current signature.  NFS clock
        # skew / touched-into-the-future files would otherwise never
        # settle (now - mtime stays negative); clamping once per
        # signature keeps the readiness test a pure stability judgment
        # without destabilizing the signature itself.
        self._eff_mtime: Dict[str, float] = {}

    def _scan(self) -> Dict[str, Sig]:
        sigs: Dict[str, Sig] = {}
        for path in sorted(glob.glob(os.path.join(self.root, self.pattern))):
            try:
                st = os.stat(path)
            except OSError:
                continue    # deleted between glob and stat
            sigs[path] = (int(st.st_size), float(st.st_mtime))
        return sigs

    def poll(self, now: Optional[float] = None
             ) -> Tuple[List[str], int]:
        """One poll: -> (paths ready to ingest, count still pending).

        Pending counts files that are present but not yet stable —
        first-seen this poll, signature still moving, or settling.
        """
        if now is None:
            now = time.time()
        sigs = self._scan()
        ready: List[str] = []
        pending = 0
        for path, sig in sigs.items():
            if self._last.get(path) != sig:
                self._eff_mtime[path] = min(sig[1], now)
            if self._ingested.get(path) == sig:
                continue
            if self._last.get(path) == sig \
                    and now - self._eff_mtime[path] >= self.settle_s:
                ready.append(path)
            else:
                pending += 1
        self._last = sigs
        self._eff_mtime = {p: m for p, m in self._eff_mtime.items()
                           if p in sigs}
        return ready, pending

    def sig(self, path: str) -> Optional[Sig]:
        """Last-scanned signature of `path` (None if not seen)."""
        return self._last.get(path)

    def mark_ingested(self, path: str) -> None:
        sig = self._last.get(path)
        if sig is not None:
            self._ingested[path] = sig

    def ingested_sigs(self) -> Dict[str, Sig]:
        """Snapshot of the ingested-signature map (checkpointing)."""
        return dict(self._ingested)

    def restore_ingested(self, sigs: Dict[str, Sig]) -> None:
        """Adopt a checkpointed ingested-signature map: files whose
        on-disk signature still matches are never re-offered (and so
        never re-read) after a resume."""
        self._ingested = {p: (int(s[0]), float(s[1]))
                          for p, s in sigs.items()}


@dataclasses.dataclass
class WatchConfig:
    root: str
    mesh: MeshSpec
    pattern: str = "*.jsonl"
    hw: Hardware = H100     # the detectors' hardware (captures carry their pricing)
    out: Optional[str] = None           # rolling session save (.json/.npz)
    report_json: Optional[str] = None
    report_html: Optional[str] = None
    summary: Optional[str] = None
    settle_s: float = 0.25
    interval_s: float = 1.0
    once: bool = False
    fail_on: str = "never"
    max_rounds: Optional[int] = None
    expected_axes: Optional[Dict[str, str]] = None
    quiet: bool = False
    # fault tolerance: per-file failure policy ("salvage" recovers the
    # intact rows of a damaged capture, "skip" quarantines it
    # whole, "raise" crashes the daemon — strict mode), bounded by
    # `max_retries` same-signature re-attempts with exponential backoff
    # before the quarantine seals until the file changes
    errors: str = "salvage"
    max_retries: int = 3
    retry_backoff_s: float = 0.5
    # crash-resume checkpoint (.npz): retained per-file traces + watcher
    # signatures + quarantine/ingest records, atomically rewritten after
    # every state-changing poll; a daemon restarted on the same
    # checkpoint resumes without re-parsing already-ingested files
    checkpoint: Optional[str] = None


class WatchDaemon:
    """The streaming-ingest loop behind `session watch`.

    Drives a `DirWatcher`, reads each ready file through the same
    per-file reader batch ingest uses (`dump.trace_from_capture`), and
    folds the resulting trace into the rolling aggregates.  `poll_once`
    is the unit tests drive directly; `run` wraps it in the sleep loop
    with `--once` quiescence detection.
    """

    CHECKPOINT_VERSION = 1

    def __init__(self, cfg: WatchConfig):
        if cfg.errors not in ("raise", "skip", "salvage"):
            raise ValueError(f"errors must be 'raise', 'skip' or 'salvage', "
                             f"got {cfg.errors!r}")
        self.cfg = cfg
        self.watcher = DirWatcher(cfg.root, cfg.pattern, cfg.settle_s)
        self._traces: Dict[str, Trace] = {}     # path -> per-file trace
        self._lint: Dict[str, List[detect.Finding]] = {}    # path -> findings
        # path -> IngestRecord-shaped dict (ok/salvaged/quarantined) —
        # the daemon's provenance ledger, mirrored into summary(),
        # session().ingest_report and the checkpoint
        self._records: Dict[str, Dict[str, object]] = {}
        # path -> {"sig": [size, mtime], "failures": n, "error": str,
        #          "retry_at": t}; sealed entries (failures >= max
        # retries) are also marked ingested so they stop being offered
        # until the file's signature changes
        self._quarantine: Dict[str, Dict[str, object]] = {}
        # files actually read this process (resume tests assert a
        # restored daemon re-reads nothing)
        self.parse_count = 0
        self.rounds = 0
        self._dirty = False     # state changed since last checkpoint write
        self._changed = False   # state changed since last emit (run loop)
        self._reset_rolling()
        if cfg.checkpoint and os.path.exists(cfg.checkpoint):
            self._load_checkpoint(cfg.checkpoint)

    # -- streaming state -----------------------------------------------------

    def _reset_rolling(self) -> None:
        self.rolling = TraceStore.empty()
        self.rollups = {"kind_link": IncrementalRollup("kind_link"),
                        "semantic": IncrementalRollup("semantic")}
        self.detector = detect.DetectorState(
            expected_axes=self.cfg.expected_axes, hw=self.cfg.hw)
        self.op_stats = HloOpStats()

    def _fold(self, trace: Trace) -> None:
        self.rolling.append(trace.store)
        for roll in self.rollups.values():
            roll.update(trace.store)
        self.detector.update(trace)
        self.op_stats = HloOpStats.merged([self.op_stats, trace.op_stats])

    def _rebuild(self) -> None:
        # streaming state cannot subtract a stale file's contribution;
        # re-fold the retained per-file traces (no re-read)
        self._reset_rolling()
        for path in sorted(self._traces):
            self._fold(self._traces[path])

    def ingest(self, path: str, attempts: int = 1) -> Trace:
        """Read one settled file and fold it into the rolling state.

        Strict read first; under `errors="salvage"` a failure falls back
        to salvage recovery (`trace_from_capture(recover=True)`) and the
        record carries the `SalvageReport`.  Any exception that escapes
        (undecodable bytes, strict-mode failure, a capture of another
        mesh) is the caller's quarantine signal.
        """
        from repro_torch.core.dump import read_capture, trace_from_capture
        text = read_capture(path)
        label = os.path.splitext(os.path.basename(path))[0]
        changed = path in self._traces
        self.parse_count += 1
        rec = {"source": path, "label": label, "status": "ok",
               "attempts": attempts, "error": "", "salvage": None}
        try:
            trace = trace_from_capture(text, self.cfg.mesh, label=label)
        except Exception as e:
            if self.cfg.errors != "salvage":
                raise
            trace = trace_from_capture(text, self.cfg.mesh, label=label,
                                       recover=True)
            rec["status"] = "salvaged"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["salvage"] = trace.salvage.to_dict()
        self._traces[path] = trace
        self._records[path] = rec
        self._quarantine.pop(path, None)
        # static analysis is per capture: one CommcheckState per file,
        # findings cached until the file itself changes
        st = commcheck.CommcheckState(self.cfg.mesh)
        st.update(trace.store)
        self._lint[path] = st.findings()
        if changed:
            self._rebuild()
        else:
            self._fold(trace)
        self._dirty = self._changed = True
        return trace

    def _quarantine_file(self, path: str, err: BaseException,
                         now: float) -> None:
        """Record a failed ingest: backoff-limited same-signature
        retries, sealed (until the signature changes) once exhausted."""
        sig = self.watcher.sig(path)
        q = self._quarantine.get(path)
        failures = (int(q["failures"]) if q else 0) + 1
        self._quarantine[path] = {
            "sig": list(sig) if sig is not None else None,
            "failures": failures,
            "error": f"{type(err).__name__}: {err}",
            "retry_at": now + self.cfg.retry_backoff_s * (1 << (failures - 1)),
        }
        label = os.path.splitext(os.path.basename(path))[0]
        self._records[path] = {
            "source": path, "label": label, "status": "quarantined",
            "attempts": failures, "error": f"{type(err).__name__}: {err}",
            "salvage": None}
        # a changed file that now fails loses its stale contribution —
        # batch ingest over the final directory would not have it either
        if path in self._traces:
            del self._traces[path]
            self._lint.pop(path, None)
            self._rebuild()
        if failures >= self.cfg.max_retries:
            # sealed: stop re-offering this signature; a new signature
            # (the writer finishing / a fixed capture) re-opens it
            self.watcher.mark_ingested(path)
        self._dirty = self._changed = True

    def poll_once(self, now: Optional[float] = None) -> Tuple[List[str], int]:
        """One watcher poll + ingest of everything ready.

        Quarantined files gate on their retry backoff (counted as
        pending while waiting); any per-file exception quarantines that
        file instead of killing the loop — unless `errors="raise"`.
        The checkpoint (when configured) is rewritten atomically after
        every state-changing poll.
        """
        if now is None:
            now = time.time()
        ready, pending = self.watcher.poll(now)
        ingested: List[str] = []
        for path in ready:
            q = self._quarantine.get(path)
            if q is not None and q.get("sig") is not None \
                    and tuple(q["sig"]) == self.watcher.sig(path):
                if now < float(q["retry_at"]):
                    pending += 1    # backoff not elapsed: try next poll
                    continue
            elif q is not None:
                q["failures"] = 0   # signature changed: fresh start
            attempts = (int(q["failures"]) if q else 0) + 1
            try:
                self.ingest(path, attempts=attempts)
                self.watcher.mark_ingested(path)
                ingested.append(path)
            except Exception as e:
                if self.cfg.errors == "raise":
                    raise
                self._quarantine_file(path, e, now)
                sealed = self.watcher.ingested_sigs().get(path) \
                    == self.watcher.sig(path)
                if not sealed:
                    pending += 1    # retry still scheduled
        self.rounds += 1
        if self.cfg.checkpoint and self._dirty:
            self.save_checkpoint(self.cfg.checkpoint)
        return ingested, pending

    # -- derived views -------------------------------------------------------

    def session(self):
        from repro_torch.core.session import TraceSession
        name = os.path.basename(os.path.abspath(self.cfg.root)) or "watch"
        sess = TraceSession(name,
                            [self._traces[p] for p in sorted(self._traces)])
        sess.ingest_report = self.ingest_report()
        return sess

    def ingest_report(self):
        """The daemon's provenance ledger as a `session.IngestReport`."""
        from repro_torch.core.session import IngestRecord, IngestReport
        return IngestReport(
            errors=self.cfg.errors,
            records=[IngestRecord.from_dict(self._records[p])
                     for p in sorted(self._records)])

    def degraded(self) -> List[str]:
        """Paths whose latest outcome is not a clean read."""
        return [p for p in sorted(self._records)
                if self._records[p]["status"] != "ok"]

    def findings(self) -> List[detect.Finding]:
        """Static (per-file commcheck) + dynamic (detector) findings."""
        out: List[detect.Finding] = []
        for path in sorted(self._lint):
            out.extend(self._lint[path])
        out.extend(self.detector.findings())
        return detect.rank_findings(out)

    def alerts(self) -> List[detect.Finding]:
        if self.cfg.fail_on == "never":
            return []
        rank = detect.SEVERITY_RANK
        return [f for f in self.findings()
                if rank.get(f.severity, 99) <= rank[self.cfg.fail_on]]

    def summary(self) -> Dict[str, object]:
        return {
            "root": self.cfg.root,
            "files": len(self._traces),
            "sites": int(self.rolling.n),
            "rounds": self.rounds,
            "by_kind_link": self.rollups["kind_link"].as_dict(),
            "by_semantic": self.rollups["semantic"].as_dict(),
            "findings": [f.to_dict() for f in self.findings()],
            "ingest": {
                "errors": self.cfg.errors,
                "records": [self._records[p] for p in sorted(self._records)],
                "degraded": self.degraded(),
                "quarantined": sorted(self._quarantine),
                # files read by THIS process — a resumed daemon counts
                # only the delta, the resume tests' zero-re-read witness
                "parse_count": self.parse_count,
            },
        }

    # -- crash-resume checkpoint ---------------------------------------------

    def save_checkpoint(self, path: str) -> str:
        """Atomically persist everything a restarted daemon needs.

        Same npz layout as a session save — `t{i}_`-prefixed store
        arrays over the retained per-file traces (sorted by path) plus
        one JSON side blob (`"watch"`) holding trace metadata, the
        watcher's ingested-signature map, cached lint findings, the
        quarantine and the provenance records.  Written through
        `persist.atomic_open` via the deterministic parallel npz writer
        (`persist.write_npz`), so a daemon killed mid-write leaves the
        previous complete checkpoint behind and per-poll re-saves of an
        unchanged state produce byte-identical files.
        """
        import numpy as np
        from repro_torch.core.persist import write_npz
        from repro_torch.core.session import _trace_meta
        paths = sorted(self._traces)
        arrs: Dict[str, object] = {}
        for i, p in enumerate(paths):
            arrs.update(self._traces[p].store.npz_arrays(prefix=f"t{i}_"))
        arrs["watch"] = np.array(json.dumps({
            "version": self.CHECKPOINT_VERSION,
            "root": self.cfg.root,
            "pattern": self.cfg.pattern,
            "paths": paths,
            "traces": [_trace_meta(self._traces[p]) for p in paths],
            "ingested": {p: list(s)
                         for p, s in self.watcher.ingested_sigs().items()},
            "lint": {p: [f.to_dict() for f in fs]
                     for p, fs in self._lint.items()},
            "quarantine": self._quarantine,
            "records": self._records,
            "rounds": self.rounds,
        }))
        with atomic_open(path, "wb") as f:
            write_npz(f, arrs)
        self._dirty = False
        return path

    def _load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint; tolerant — an unreadable or
        incompatible checkpoint logs a warning and starts fresh rather
        than wedging the daemon."""
        import numpy as np
        from repro_torch.core.session import _trace_from_meta
        try:
            with np.load(path) as arrs:
                side = json.loads(str(arrs["watch"]))
                if int(side.get("version", -1)) > self.CHECKPOINT_VERSION:
                    raise ValueError(
                        f"checkpoint version {side.get('version')} is newer "
                        f"than supported ({self.CHECKPOINT_VERSION})")
                traces = {
                    p: _trace_from_meta(
                        meta, TraceStore.from_npz_arrays(arrs,
                                                         prefix=f"t{i}_"))
                    for i, (p, meta) in enumerate(zip(side["paths"],
                                                      side["traces"]))}
        except Exception as e:
            self._log(f"[watch] ignoring unusable checkpoint {path}: "
                      f"{type(e).__name__}: {e}")
            return
        self._traces = traces
        self._lint = {p: [detect.Finding.from_dict(d) for d in fs]
                      for p, fs in side.get("lint", {}).items()}
        self._quarantine = side.get("quarantine", {})
        self._records = side.get("records", {})
        self.rounds = int(side.get("rounds", 0))
        self.watcher.restore_ingested(side.get("ingested", {}))
        self._rebuild()

    # -- output --------------------------------------------------------------

    def emit(self) -> None:
        """Re-write every configured artifact (all atomic replaces)."""
        cfg = self.cfg
        sess = self.session() if (cfg.out or cfg.report_json
                                  or cfg.report_html) else None
        if cfg.out:
            sess.save(cfg.out)
        for path, fmt in ((cfg.report_json, "json"),
                          (cfg.report_html, "html")):
            if path and len(sess):
                with atomic_open(path, "w") as fp:
                    sess.report(fmt=fmt, fp=fp)
        if cfg.summary:
            with atomic_open(cfg.summary, "w") as fp:
                json.dump(self.summary(), fp, indent=1)
                fp.write("\n")

    def _log(self, msg: str) -> None:
        if not self.cfg.quiet:
            print(msg, flush=True)

    # -- the loop ------------------------------------------------------------

    def run(self) -> int:
        """Poll until interrupted (daemon) or quiescent (`once`).

        `once` exits after a poll that found nothing ready *and*
        nothing pending, with at least two polls total (a pre-existing
        file needs two polls to prove stability).  Exit code: 1 when
        any finding reached `fail_on` severity, else 3 when any input
        was salvaged or quarantined (degraded ingest), else 0.
        """
        cfg = self.cfg
        emitted = False
        try:
            while True:
                ready, pending = self.poll_once()
                if self._changed or not emitted:
                    self.emit()
                    emitted = True
                    self._changed = False
                    self._log(f"[watch] round {self.rounds}: "
                              f"+{len(ready)} file(s), "
                              f"{len(self._traces)} total, "
                              f"{self.rolling.n} sites, "
                              f"{pending} pending")
                if cfg.once and not ready and not pending \
                        and self.rounds >= 2:
                    break
                if cfg.max_rounds is not None \
                        and self.rounds >= cfg.max_rounds:
                    break
                time.sleep(cfg.interval_s)
        except KeyboardInterrupt:
            self._log("[watch] interrupted")
        self.emit()
        alerts = self.alerts()
        for f in alerts:
            where = f" @ {f.site}" if f.site else ""
            print(f"[watch] ALERT [{f.severity}] {f.detector}{where}: "
                  f"{f.message}", file=sys.stderr)
        if alerts:
            return 1
        for p in self.degraded():
            r = self._records[p]
            print(f"[watch] ingest [{r['status']}] {p}: {r['error']}",
                  file=sys.stderr)
        return 3 if self.degraded() else 0
