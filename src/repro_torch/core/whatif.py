"""What-if engine: hardwareless counterfactual sweeps over an annotated trace
(a copy of the reference's `core/whatif.py`, on the port's H100 model: the
link tiers read NVLink and InfiniBand).

ucTrace's headline experiments re-run the same workload under different UCX
settings (rendezvous thresholds, transports) and compare transfer behavior
to recommend a configuration.  Our vectorized cost model makes the same
counterfactuals nearly free *without re-running anything*: a parsed
`TraceStore` keeps the raw facts (payload bytes, replica groups, op
identity) separate from the derived annotation (link class, protocol,
wire bytes, `est_time_s`), so asking "what would this trace cost on a
different mesh / protocol regime / link tier?" is one re-annotation pass
over an `annotation_clone` of the store — no re-parse, no hardware.

Core pieces:

  * `Scenario` — a named annotation override: an alternate mesh, an axis
    reordering of the baseline mesh (`axis_order`), per-axis interconnect
    remaps (`axis_kind`), a full `Hardware` swap, or field-level hardware
    overrides (`hw_overrides`, e.g. `{"rndv_threshold": 1 << 13}`).
  * `reannotate(store, scenario, mesh, hw)` — price a shared-data clone of
    the store under the scenario.  The baseline store is never mutated
    (`costmodel.annotate_store` rebinds annotation columns, it does not
    write into them); the identity scenario reproduces the baseline
    annotation byte-for-byte (pinned by tests/test_whatif.py).
  * `compare` / `sweep` — diff `est_time_s` and wire bytes per site and
    per rollup key against the baseline and rank scenarios by time saved.
  * `default_scenarios` — the standard grid: every axis reordering of the
    baseline mesh, rendezvous-threshold tiers, and link bandwidth/latency
    tiers (the all-NVLink remap is deliberately *not* in the grid — it would
    exactly tie, and thus mask, every realizable mesh refactorization).
  * `ib_saving` / `axis_reprice` — per-finding counterfactuals the
    detectors use to attach a quantified `recommendation` to findings.

Surfaced as `session whatif` (ranked table / `--json`) and as the
`recommendation` field on detector findings (reports).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import annotate_store
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import (H100, Hardware, MeshSpec, hop_latency,
                                       slowest_link_bw)


def fmt_time(t: float) -> str:
    """Human-scaled duration ("3.20 ms"), shared by CLI tables and findings."""
    t = float(t)
    if abs(t) >= 1.0:
        return f"{t:.2f} s"
    if abs(t) >= 1e-3:
        return f"{t * 1e3:.2f} ms"
    return f"{t * 1e6:.0f} us"


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

@dataclass
class Scenario:
    """One counterfactual annotation configuration.

    All fields compose: `mesh` (or `axis_order` applied to the baseline
    mesh) picks the topology, `axis_kind` then remaps per-axis
    interconnect classes, and `hw` / `hw_overrides` pick the hardware
    constants.  An empty scenario is the identity.
    """

    name: str
    description: str = ""
    mesh: Optional[MeshSpec] = None             # replace the topology outright
    axis_order: Optional[Tuple[str, ...]] = None  # reorder baseline mesh axes
    axis_kind: Mapping[str, str] = field(default_factory=dict)  # -> nvlink | ib
    hw: Optional[Hardware] = None               # replace the hardware outright
    hw_overrides: Mapping[str, float] = field(default_factory=dict)

    def resolve(self, mesh: MeshSpec, hw: Hardware) -> Tuple[MeshSpec, Hardware]:
        """The concrete (mesh, hardware) this scenario prices against."""
        m = self.mesh if self.mesh is not None else mesh
        if self.axis_order is not None:
            idx = [m.axes.index(a) for a in self.axis_order]
            m = MeshSpec(tuple(m.shape[i] for i in idx),
                         tuple(m.axes[i] for i in idx), dict(m.axis_kind))
        if self.axis_kind:
            ak = dict(m.axis_kind)
            ak.update(self.axis_kind)
            m = MeshSpec(m.shape, m.axes, ak)
        h = self.hw if self.hw is not None else hw
        if self.hw_overrides:
            h = replace(h, **dict(self.hw_overrides))
        return m, h


IDENTITY = Scenario("baseline", "the trace's own mesh and hardware")


def reannotate(store: TraceStore, scenario: Scenario, mesh: MeshSpec,
               hw: Hardware = H100) -> TraceStore:
    """Price `store` under `scenario` without touching the baseline.

    Returns a new `TraceStore` sharing the row data (payload bytes,
    groups, op identity) with `store` by reference; only the annotation
    columns differ.  One vectorized `annotate_store` pass per call.
    """
    m, h = scenario.resolve(mesh, hw)
    alt = store.annotation_clone()
    annotate_store(alt, m, h)
    return alt


def default_scenarios(mesh: MeshSpec, hw: Hardware = H100,
                      rndv_tiers: Sequence[int] = (1 << 13, 1 << 18),
                      max_mesh_perms: int = 6) -> List[Scenario]:
    """The standard sweep grid for a trace annotated on (mesh, hw)."""
    out: List[Scenario] = []
    rank = len(mesh.axes)
    if rank >= 2:
        perms = [p for p in itertools.permutations(range(rank))
                 if p != tuple(range(rank))][:max_mesh_perms]
        for p in perms:
            axes = tuple(mesh.axes[i] for i in p)
            shape = tuple(mesh.shape[i] for i in p)
            out.append(Scenario(
                f"mesh:{','.join(axes)}",
                f"refactor the device mesh to {shape} {axes} "
                f"(same devices, different id->coordinate mapping)",
                axis_order=axes))
    for t in rndv_tiers:
        if int(t) != int(hw.rndv_threshold):
            out.append(Scenario(
                f"rndv:{t >> 10}KiB",
                f"rendezvous threshold {t} B/shard — shifts the "
                f"eager/rndv protocol split (labels only; est_time is "
                f"protocol-independent in this model)",
                hw_overrides={"rndv_threshold": int(t)}))
    out.append(Scenario("nvlink-2x", "double the NVLink bandwidth per GPU",
                        hw_overrides={"nvlink_bw": hw.nvlink_bw * 2}))
    out.append(Scenario("lat-half", "halve the per-step collective latencies",
                        hw_overrides={"nvlink_latency_s": hw.nvlink_latency_s / 2,
                                      "ib_latency_s": hw.ib_latency_s / 2}))
    if any(k == "ib" for k in mesh.axis_kind.values()):
        out.append(Scenario("ib-2x", "double the InfiniBand bandwidth per GPU",
                            hw_overrides={"ib_bw": hw.ib_bw * 2}))
    # note: the all-NVLink remap (`ib_saving`) is deliberately absent — it
    # upper-bounds every mesh refactorization by construction, so ranking
    # it alongside realizable configurations would only ever tie or beat
    # them; it quantifies `cross_node_bulk` findings instead
    return out


# --------------------------------------------------------------------------
# diffs
# --------------------------------------------------------------------------

def _site_codes(store: TraceStore) -> Tuple[np.ndarray, List[str]]:
    # the what-if site key is op_name x kind — deliberately *excluding*
    # the axes label the report rollups use, because axes are part of the
    # annotation a scenario changes; this key is identical across every
    # re-annotation of the same rows
    return store._join_codes((store.op_name, store.kind))


def site_deltas(base: TraceStore, alt: TraceStore) -> Dict[str, float]:
    """Per-site `est_time_s` change (alt - base), multiplicity-weighted.

    `alt` must be a re-annotation of `base`'s rows (same row order).
    Antisymmetric by construction: `site_deltas(a, b)[k] ==
    -site_deltas(b, a)[k]` for every site key `k`.
    """
    if base.n == 0:
        return {}
    codes, labels = _site_codes(base)
    d = (alt.est_time_s - base.est_time_s) * base.weights
    sums = np.bincount(codes, weights=d, minlength=len(labels))
    return {lab: float(sums[i]) for i, lab in enumerate(labels)}


def _site_times(store: TraceStore) -> Tuple[List[str], np.ndarray]:
    codes, labels = _site_codes(store)
    t = np.bincount(codes, weights=store.est_time_s * store.weights,
                    minlength=len(labels))
    return labels, t


@dataclass
class ScenarioResult:
    """One scenario's diff against the baseline annotation."""

    scenario: Scenario
    mesh: MeshSpec
    hw: Hardware
    baseline_s: float
    est_s: float
    baseline_wire: float
    wire: float
    baseline_eager: int         # weighted eager-protocol executions
    eager: int
    by_key: Dict[str, Tuple[float, float]]      # label -> (base_s, alt_s)
    top_sites: List[Dict[str, object]]          # largest per-site savings

    @property
    def saved_s(self) -> float:
        return self.baseline_s - self.est_s

    @property
    def speedup(self) -> float:
        return self.baseline_s / self.est_s if self.est_s > 0 else float("inf")

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.scenario.name,
            "description": self.scenario.description,
            "mesh": {"shape": list(self.mesh.shape),
                     "axes": list(self.mesh.axes),
                     "axis_kind": dict(self.mesh.axis_kind)},
            "est_time_s": self.est_s,
            "baseline_s": self.baseline_s,
            "saved_s": self.saved_s,
            "speedup": self.speedup,
            "wire_bytes": self.wire,
            "wire_saved_bytes": self.baseline_wire - self.wire,
            "eager_sites": self.eager,
            "baseline_eager_sites": self.baseline_eager,
            "by_key": {k: {"baseline_s": b, "est_time_s": a}
                       for k, (b, a) in self.by_key.items()},
            "top_sites": self.top_sites,
        }


def _weighted_eager(store: TraceStore) -> int:
    mask = store.protocol.mask_of("eager") if store.n else \
        np.zeros(0, dtype=bool)
    return int(store.multiplicity[mask].sum()) if store.n else 0


def compare(base: TraceStore, scenario: Scenario, mesh: MeshSpec,
            hw: Hardware = H100, top: int = 5) -> ScenarioResult:
    """Re-annotate under `scenario` and diff against the baseline."""
    m, h = scenario.resolve(mesh, hw)
    alt = reannotate(base, scenario, mesh, hw)
    w = base.weights
    base_t = float(np.dot(base.est_time_s, w))
    alt_t = float(np.dot(alt.est_time_s, w))
    by_key: Dict[str, Tuple[float, float]] = {}
    if base.n:
        labels, mat = base.rollup("kind_link")
        for i, lab in enumerate(labels):
            by_key[lab] = (float(mat[3, i]), 0.0)
        labels, mat = alt.rollup("kind_link")
        for i, lab in enumerate(labels):
            b, _a = by_key.get(lab, (0.0, 0.0))
            by_key[lab] = (b, float(mat[3, i]))
    top_sites: List[Dict[str, object]] = []
    if base.n:
        labels, bt = _site_times(base)
        _, at = _site_times(alt)
        saved = bt - at
        order = np.argsort(-saved, kind="stable")[:top]
        for i in order:
            if saved[i] == 0.0:
                continue
            top_sites.append({
                "site": labels[i],
                "baseline_s": float(bt[i]),
                "est_time_s": float(at[i]),
                "saved_s": float(saved[i]),
                "speedup": float(bt[i] / at[i]) if at[i] > 0 else float("inf"),
            })
    return ScenarioResult(
        scenario=scenario, mesh=m, hw=h,
        baseline_s=base_t, est_s=alt_t,
        baseline_wire=float(np.dot(base.wire_total, w)),
        wire=float(np.dot(alt.wire_total, w)),
        baseline_eager=_weighted_eager(base), eager=_weighted_eager(alt),
        by_key=by_key, top_sites=top_sites)


def sweep(store: TraceStore, mesh: MeshSpec, hw: Hardware = H100,
          scenarios: Optional[Sequence[Scenario]] = None,
          top: int = 5) -> List[ScenarioResult]:
    """Price every scenario and rank by time saved (largest first)."""
    if scenarios is None:
        scenarios = default_scenarios(mesh, hw)
    results = [compare(store, sc, mesh, hw, top=top) for sc in scenarios]
    results.sort(key=lambda r: -r.saved_s)
    return results


def sweep_to_dict(results: Sequence[ScenarioResult], label: str,
                  mesh: MeshSpec) -> Dict[str, object]:
    """The stable `session whatif --json` schema."""
    base = results[0] if results else None
    return {
        "label": label,
        "mesh": {"shape": list(mesh.shape), "axes": list(mesh.axes),
                 "axis_kind": dict(mesh.axis_kind)},
        "baseline": {
            "est_time_s": base.baseline_s if base else 0.0,
            "wire_bytes": base.baseline_wire if base else 0.0,
            "eager_sites": base.baseline_eager if base else 0,
        },
        "scenarios": [r.to_dict() for r in results],
    }


def render_sweep(results: Sequence[ScenarioResult], label: str,
                 top_sites: int = 3) -> str:
    """Ranked human-readable table for `session whatif`."""
    lines = [f"what-if sweep: {label}"]
    if not results:
        return lines[0] + "\n  (no scenarios)"
    lines.append(f"  baseline est {fmt_time(results[0].baseline_s)} / step")
    lines.append(f"  {'scenario':<22} {'est/step':>10} {'saved':>10} "
                 f"{'speedup':>8}  note")
    for r in results:
        note = ""
        if r.eager != r.baseline_eager:
            note = f"eager sites {r.baseline_eager} -> {r.eager}"
        lines.append(f"  {r.scenario.name:<22} {fmt_time(r.est_s):>10} "
                     f"{fmt_time(r.saved_s):>10} {r.speedup:>7.2f}x  {note}")
    best = results[0]
    if best.saved_s > 0:
        lines.append(f"  best: {best.scenario.name} — "
                     f"{best.scenario.description}")
        for s in best.top_sites[:top_sites]:
            lines.append(f"    {s['site']}: {fmt_time(s['baseline_s'])} -> "
                         f"{fmt_time(s['est_time_s'])} "
                         f"({s['speedup']:.2f}x)")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# per-finding counterfactuals (detector recommendation quantifiers)
# --------------------------------------------------------------------------

def ib_saving(store: TraceStore, mesh: MeshSpec, hw: Hardware = H100) -> float:
    """Time/step saved by the all-NVLink scenario (hierarchical-reduction cap).

    Re-prices the store with every axis classed as NVLink and returns the
    weighted `est_time_s` drop — the ceiling on what keeping cross-node
    bulk traffic inside a node could recover.  Rows that never touch
    InfiniBand price identically, so the delta is exactly the IB rows' share.
    """
    if store.n == 0:
        return 0.0
    sc = Scenario("nvlink-everywhere", axis_kind={a: "nvlink" for a in mesh.axes})
    alt = reannotate(store, sc, mesh, hw)
    d = (store.est_time_s - alt.est_time_s) * store.weights
    return float(d.sum())


def axis_reprice(store: TraceStore, row: int, want_axis: str, mesh: MeshSpec,
                 hw: Hardware = H100) -> float:
    """Time/exec saved if row `row` rode only `want_axis` (axis-detour fix).

    Keeps the row's wire bytes and hop count and re-prices them at the
    expected axis's link bandwidth and latency — the counterfactual for
    "this grad-sync should have stayed on the data axis".  Returns 0 when
    the expected axis is unknown or the row carries no annotation.
    """
    if want_axis not in mesh.axes:
        return 0.0
    axes = store.axes_tables[store.axes_code[row]]
    if not axes:
        return 0.0
    est = float(store.est_time_s[row])
    wire = float(store.wire_bytes_per_device[row])
    bw0 = slowest_link_bw(mesh, axes, hw)
    lat0 = hop_latency(mesh, axes, hw)
    t_bw0 = wire / (hw.ring_directions * bw0)
    hops = (est - t_bw0) / lat0 if lat0 > 0 else 0.0
    want = (want_axis,)
    alt = hops * hop_latency(mesh, want, hw) \
        + wire / (hw.ring_directions * slowest_link_bw(mesh, want, hw))
    return max(0.0, est - alt)
