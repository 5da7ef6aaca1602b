"""Performance-bug detectors — the paper's Fig 7 (NUMA misbinding) analogue
(a copy of the reference's `core/detect.py`; its cross-pod detector reads
InfiniBand between nodes here: `detect_cross_node_bulk`).

On an IB/GPU cluster the classic silent misconfiguration is traffic taking a
host detour because of process placement.  On a device mesh the analogue is
traffic taking an *axis* detour because of bad sharding specs, or bulk
traffic riding InfiniBand that a node's NVLink could carry.  Each detector
inspects the assembled trace and returns human-actionable findings; where the
cost model can price the fix, the finding carries a quantified
`recommendation` ("est X ms/step saved") backed by the what-if engine
(`repro_torch.core.whatif`) — re-pricing the implicated rows under the fixed
configuration, not a heuristic guess.

Detectors scan the columnar `TraceStore`: candidate filtering is a numpy
mask over interned code columns, and only the (few) survivors are
materialized as rows for message construction — on 100k-event traces the
scans no longer walk Python objects.

Layout thrash reads `Trace.op_stats.transpose_bytes`, which the reference
fills from its HLO; the port's captured traces carry empty `HloOpStats`, so
that detector stays silent on them (it fires on sessions loaded from the
reference's files).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import HloOpStats, Trace
from repro_torch.core.topology import H100, Hardware, MeshSpec
from repro_torch.core.whatif import axis_reprice, fmt_time, ib_saving

# severity -> rank; lower sorts first.  Shared by the dynamic detectors
# below and the static analyzer (commcheck) — one ordering, one schema.
SEVERITY_RANK: Dict[str, int] = {"critical": 0, "warn": 1, "info": 2}


@dataclass
class Finding:
    """One diagnostic, shared between the dynamic detectors and the
    static analyzer (`commcheck`).

    `detector` doubles as the stable finding code (`session lint --json`
    / `session detect --json` key consumers match on), `site` anchors the
    finding to an op / channel / spec path, and `wasted_bytes` /
    `time_at_risk_s` carry the cost-model ranking weight.
    `recommendation` states the fix with the time it is worth;
    `est_saved_s` is that figure as a number — for the dynamic detectors
    it comes from re-pricing the trace under the fix scenario
    (`core.whatif`), for the static analyzer it is the modeled time the
    broken collectives block.
    """

    detector: str
    severity: str          # info | warn | critical
    message: str
    wasted_bytes: float = 0.0
    site: str = ""
    time_at_risk_s: float = 0.0
    recommendation: str = ""
    est_saved_s: float = 0.0

    def __str__(self):
        return f"[{self.severity}] {self.detector}: {self.message}"

    def to_dict(self) -> Dict[str, object]:
        """The stable JSON schema (identical for `lint` and `detect`)."""
        return {
            "analyzer": self.detector,
            "severity": self.severity,
            "site": self.site,
            "message": self.message,
            "wasted_bytes": float(self.wasted_bytes),
            "time_at_risk_s": float(self.time_at_risk_s),
            "recommendation": self.recommendation,
            "est_saved_s": float(self.est_saved_s),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Finding":
        """Inverse of `to_dict` (restoring saved findings).

        Tolerant of the pre-recommendation schema: checkpoints written
        before the what-if fields existed restore with empty defaults.
        """
        return cls(detector=d["analyzer"], severity=d["severity"],
                   message=d["message"],
                   wasted_bytes=float(d.get("wasted_bytes", 0.0)),
                   site=d.get("site", ""),
                   time_at_risk_s=float(d.get("time_at_risk_s", 0.0)),
                   recommendation=d.get("recommendation", ""),
                   est_saved_s=float(d.get("est_saved_s", 0.0)))


def rank_findings(findings: List[Finding]) -> List[Finding]:
    """Severity-major, wire-bytes-at-risk-minor ordering (stable)."""
    return sorted(findings,
                  key=lambda f: (SEVERITY_RANK.get(f.severity, 99),
                                 -f.wasted_bytes))


# -- finding constructors ----------------------------------------------------
# Shared by the batch detectors below and the streaming `DetectorState`:
# one message format, so incremental findings are string-identical to a
# batch run over the same union of rows.  The quantified `recommendation`
# comes from re-pricing the implicated rows under the fix scenario
# (`core.whatif`); batch and streaming runs feed the same per-row sums
# into these constructors.

def _f_redundant(count: int, kind: str, nbytes: int, link: str, scope: str,
                 comp: str, mult: int, time_s: float = 0.0) -> Finding:
    saved = (count - 1) / count * time_s
    return Finding(
        "redundant_collective", "warn",
        f"{count}x identical {kind} of {nbytes/1e6:.1f} MB "
        f"on {link} "
        f"(scope '{scope or '-'}', "
        f"comp '{comp}') — candidates for CSE "
        f"or re-materialization of the gathered value",
        wasted_bytes=(count - 1) * nbytes * mult, site=scope,
        recommendation=f"deduplicate: {count - 1} of {count} sites move the "
                       f"same value — est {fmt_time(saved)}/step reclaimable "
                       f"(CSE scenario)",
        est_saved_s=saved)


def _f_detour(sem: str, kind: str, nbytes: int, axes, want: str, scope: str,
              mult: int, saved_s: float = 0.0) -> Finding:
    return Finding(
        "axis_detour", "warn",
        f"{sem} {kind} "
        f"({nbytes/1e6:.1f} MB) spans "
        f"axes {axes}, expected only '{want}' — check the "
        f"PartitionSpec feeding scope '{scope or '-'}'",
        wasted_bytes=nbytes * mult, site=scope,
        recommendation=f"keep {sem} on '{want}': est {fmt_time(saved_s)}/step "
                       f"saved (payload re-priced on the expected axis)",
        est_saved_s=saved_s)


def _f_eager(n: int, lat: float, hw: Hardware) -> Finding:
    return Finding(
        "eager_flood", "info",
        f"{n} latency-bound collectives/step (< {hw.rndv_threshold/1024:.0f} KiB "
        f"payload/shard), ~{lat*1e6:.0f} us serialized latency — consider "
        f"fusing/batching small collectives or increasing scan body size",
        time_at_risk_s=lat,
        recommendation=f"fuse/batch the small collectives: up to "
                       f"{fmt_time(lat)}/step of eager-protocol time "
                       f"reclaimable (full-fusion ceiling)",
        est_saved_s=lat)


def _f_layout(op_stats: HloOpStats, hw: Hardware = H100) -> Finding:
    saved = op_stats.transpose_bytes / hw.hbm_bw
    return Finding(
        "layout_thrash", "info",
        f"{op_stats.transpose_bytes/1e9:.2f} GB of transpose/copy traffic "
        f"({op_stats.n_transpose} ops) — review operand layouts or "
        f"einsum dimension orders adjacent to collectives",
        recommendation=f"align operand layouts to delete the transposes: "
                       f"est {fmt_time(saved)}/step of HBM traffic "
                       f"reclaimable",
        est_saved_s=saved)


def _f_cross_node(total: float, count: int, saved_s: float = 0.0) -> Finding:
    return Finding(
        "cross_node_bulk", "warn",
        f"{total/1e9:.2f} GB/step crosses InfiniBand between nodes "
        f"({count} collectives) — hierarchical reduction "
        f"(in-node reduce-scatter over NVLink, cross-node exchange of "
        f"1/node_size) or gradient compression recommended",
        recommendation=f"keep bulk traffic inside the node: est "
                       f"{fmt_time(saved_s)}/step saved (all-NVLink ceiling "
                       f"scenario)",
        est_saved_s=saved_s)


def _trace_mesh(trace: Trace) -> Optional[MeshSpec]:
    try:
        return MeshSpec(tuple(trace.mesh_shape), tuple(trace.mesh_axes))
    except (AssertionError, TypeError):
        return None     # malformed mesh metadata: skip quantification


def detect_redundant_gathers(trace: Trace) -> List[Finding]:
    """Same tensor gathered more than once per execution context.

    (ucTrace: repeated identical UCT transfers within one MPI call.)
    """
    s = trace.store
    cand = s.kind.mask_of("all-gather", "all-reduce") \
        & (s.operand_bytes > (1 << 20))
    idx = np.flatnonzero(cand)
    if len(idx) < 2:
        return []
    # composite (kind, bytes, link, scope, computation) key per candidate
    key = np.zeros(len(idx), dtype=np.int64)
    for cat in (s.kind, s.link_class, s.scope, s.computation):
        key = key * len(cat.vocab) + cat.codes[idx]
    _, uniq_bytes = np.unique(s.operand_bytes[idx], return_inverse=True)
    key = key * (uniq_bytes.max() + 1) + uniq_bytes
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    out = []
    for g in np.flatnonzero(counts > 1):
        members = idx[inv == g]
        last = int(members[-1])
        time_s = float((s.est_time_s[members] * s.weights[members]).sum())
        out.append(_f_redundant(
            int(counts[g]), s.kind.value(last), int(s.operand_bytes[last]),
            s.link_class.value(last), s.scope.value(last),
            s.computation.value(last), int(s.multiplicity[last]), time_s))
    return out


def detect_axis_detours(trace: Trace, expected: Dict[str, str],
                        min_bytes: int = 1 << 20,
                        hw: Hardware = H100) -> List[Finding]:
    """Collectives spanning mesh axes their semantic class should not touch.

    `expected` maps semantic class -> axis name it should stay on
    (e.g. {"grad_sync": "data", "moe_dispatch": "model"}).  A grad-sync that
    crosses `model`, or TP traffic crossing `data`, is the sharding analogue
    of NUMA-misbound traffic routed through remote NICs.  Sub-MB payloads
    (scalar metric reductions, grad-norm psums) are exempt.
    """
    s = trace.store
    mesh = _trace_mesh(trace)
    cand = s.semantic.mask_of(*expected) \
        & (s.operand_bytes * s.multiplicity >= min_bytes)
    out = []
    for i in np.flatnonzero(cand):
        axes = s.axes[i]
        if not axes:
            continue
        want = expected[s.semantic.value(i)]
        if any(a != want for a in axes):
            mult = int(s.multiplicity[i])
            saved = axis_reprice(s, int(i), want, mesh, hw) * mult \
                if mesh is not None else 0.0
            out.append(_f_detour(
                s.semantic.value(i), s.kind.value(i),
                int(s.operand_bytes[i]), axes, want, s.scope.value(i),
                mult, saved))
    return out


def detect_eager_floods(trace: Trace, hw: Hardware = H100,
                        min_count: int = 64) -> List[Finding]:
    """Many tiny latency-bound transfers (the eager-protocol flood).

    (ucTrace Fig 4/6: am_short floods where rendezvous would batch.)
    """
    s = trace.store
    mask = s.protocol.mask_of("eager")
    n = int(s.multiplicity[mask].sum())
    if n >= min_count:
        lat = float((s.est_time_s[mask] * s.weights[mask]).sum())
        return [_f_eager(n, lat, hw)]
    return []


def detect_layout_thrash(trace: Trace, threshold_bytes: float = 1 << 30,
                         hw: Hardware = H100) -> List[Finding]:
    """Heavy transpose/copy traffic around sharded ops (layout mismatch)."""
    tb = trace.op_stats.transpose_bytes
    if tb > threshold_bytes:
        return [_f_layout(trace.op_stats, hw)]
    return []


def _safe_ib_saving(store, mesh: Optional[MeshSpec], hw: Hardware) -> float:
    """`whatif.ib_saving`, tolerating un-annotatable stores (traces with
    out-of-range device ids cannot be re-priced — quantify as 0)."""
    if mesh is None:
        return 0.0
    try:
        return ib_saving(store, mesh, hw)
    except (ValueError, IndexError, KeyError):
        return 0.0


# link classes that ride InfiniBand: one axis between nodes, several, or a
# group that crosses both NVLink and InfiniBand
CROSS_NODE = ("ib.", "xnode.")


def detect_cross_node_bulk(trace: Trace, hw: Hardware = H100) -> List[Finding]:
    """Bulk traffic on InfiniBand between nodes that could stay on a node's NVLink."""
    s = trace.store
    mask = s.link_class.mask_prefix(CROSS_NODE)
    total = float((s.wire_total[mask] * s.weights[mask]).sum())
    out = []
    if total > 1 << 30:
        saved = _safe_ib_saving(s, _trace_mesh(trace), hw)
        out.append(_f_cross_node(total, int(mask.sum()), saved))
    return out


def run_all(trace: Trace, expected_axes: Dict[str, str] | None = None,
            hw: Hardware = H100) -> List[Finding]:
    """All detectors, ranked critical > warn > info, bytes-at-risk within."""
    findings = []
    findings += detect_redundant_gathers(trace)
    if expected_axes:
        findings += detect_axis_detours(trace, expected_axes, hw=hw)
    findings += detect_eager_floods(trace, hw)
    findings += detect_layout_thrash(trace, hw=hw)
    findings += detect_cross_node_bulk(trace, hw)
    return rank_findings(findings)


class DetectorState:
    """Streaming `run_all`: fold ingested chunks in, render fresh findings.

    `update(trace)` absorbs one file/chunk; `findings()` then returns
    what `run_all` would report over the *union* of every chunk seen so
    far, without rescanning old rows — per-detector sufficient
    statistics (composite-key counts for redundant collectives, eager /
    cross-node sums, merged op stats) are all that is retained, so state
    is sized by unique keys, not rows.  Messages reuse the same
    constructors as the batch detectors and are string-identical; the
    accumulated float sums group per chunk, so they are close (not
    bitwise) to a single batch pass, and equal-severity/equal-bytes ties
    may order differently under `rank_findings`' stable sort.
    """

    def __init__(self, expected_axes: Optional[Dict[str, str]] = None,
                 hw: Hardware = H100, min_count: int = 64,
                 thrash_threshold: float = 1 << 30):
        self.expected_axes = expected_axes
        self.hw = hw
        self.min_count = min_count
        self.thrash_threshold = thrash_threshold
        # (kind, link, scope, comp, bytes) -> {count, time, mult-of-last}
        self._redundant: Dict[Tuple, Dict[str, float]] = {}
        self._detours: List[Finding] = []
        self._eager_n = 0
        self._eager_lat = 0.0
        self._op = HloOpStats()
        self._xnode_total = 0.0
        self._xnode_count = 0
        self._xnode_saved = 0.0

    def update(self, trace: Trace) -> None:
        s = trace.store
        self._update_redundant(s)
        if self.expected_axes:
            self._detours += detect_axis_detours(trace, self.expected_axes,
                                                 hw=self.hw)
        mask = s.protocol.mask_of("eager")
        self._eager_n += int(s.multiplicity[mask].sum())
        self._eager_lat += float((s.est_time_s[mask] * s.weights[mask]).sum())
        self._op = HloOpStats.merged([self._op, trace.op_stats])
        mask = s.link_class.mask_prefix(CROSS_NODE)
        self._xnode_total += float((s.wire_total[mask] * s.weights[mask]).sum())
        self._xnode_count += int(mask.sum())
        if mask.any():
            # the all-NVLink re-pricing delta is row-local, so per-chunk
            # accumulation matches a batch pass over the union
            self._xnode_saved += _safe_ib_saving(s, _trace_mesh(trace), self.hw)

    def _update_redundant(self, s) -> None:
        # same candidate filter + composite key as the batch detector,
        # folded by *value* (codes are chunk-local) — a lone candidate
        # kept here may pair with a duplicate arriving chunks later
        cand = s.kind.mask_of("all-gather", "all-reduce") \
            & (s.operand_bytes > (1 << 20))
        idx = np.flatnonzero(cand)
        if not len(idx):
            return
        key = np.zeros(len(idx), dtype=np.int64)
        for cat in (s.kind, s.link_class, s.scope, s.computation):
            key = key * len(cat.vocab) + cat.codes[idx]
        _, uniq_bytes = np.unique(s.operand_bytes[idx], return_inverse=True)
        key = key * (uniq_bytes.max() + 1) + uniq_bytes
        _, inv, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
        for g in range(len(counts)):
            members = idx[inv == g]
            last = int(members[-1])
            vkey = (s.kind.value(last), s.link_class.value(last),
                    s.scope.value(last), s.computation.value(last),
                    int(s.operand_bytes[last]))
            rec = self._redundant.setdefault(
                vkey, {"count": 0, "time": 0.0, "mult": 1})
            rec["count"] += int(counts[g])
            rec["time"] += float(
                (s.est_time_s[members] * s.weights[members]).sum())
            rec["mult"] = int(s.multiplicity[last])

    def findings(self) -> List[Finding]:
        out = []
        for (kind, link, scope, comp, nbytes), rec in self._redundant.items():
            if rec["count"] > 1:
                out.append(_f_redundant(int(rec["count"]), kind, nbytes, link,
                                        scope, comp, int(rec["mult"]),
                                        rec["time"]))
        out += self._detours
        if self._eager_n >= self.min_count:
            out.append(_f_eager(self._eager_n, self._eager_lat, self.hw))
        if self._op.transpose_bytes > self.thrash_threshold:
            out.append(_f_layout(self._op, self.hw))
        if self._xnode_total > 1 << 30:
            out.append(_f_cross_node(self._xnode_total, self._xnode_count,
                                     self._xnode_saved))
        return rank_findings(out)
