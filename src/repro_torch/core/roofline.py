"""Three-term roofline of a traced step (a copy of the reference's
`core/roofline.py`, on the port's H100 `Hardware`).

    compute    = HLO_FLOPs            / (chips x peak_FLOP/s)
    memory     = HLO_bytes_accessed   / (chips x HBM_bw)
    collective = collective_bytes     / (chips x link_bw)

`collective_bytes` is the summed operand sizes of every collective site
(x multiplicity) the capture recorded (`core/capture.py`); the FLOP term
reads the step's counted FLOPs (`Trace.hlo_flops`).  Every term divides by
the `hw` passed in, the model-FLOPs bound too (the reference hard-codes
its chip's peak there).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.events import Trace
from repro_torch.core.topology import H100, Hardware


@dataclass
class RooflineReport:
    label: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float = 0.0
    per_device_memory_bytes: float = 0.0
    peak_flops: float = H100.flops_bf16

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """(MODEL_FLOPS/chips) / HLO_FLOPs — remat/redundancy waste detector.

        model_flops is global; hlo_flops is the per-device SPMD program.
        """
        if not self.hlo_flops:
            return 0.0
        return self.model_flops / self.chips / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = perfectly compute-bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    @property
    def model_roofline_fraction(self) -> float:
        """MODEL_FLOPS-based fraction of peak at the modeled step time.

        (model_flops / chips / peak) / bound_s — the honest MFU bound the
        compiled program could reach if perfectly overlapped.
        """
        if not self.bound_s:
            return 0.0
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / self.bound_s

    def row(self) -> Dict[str, object]:
        return {
            "label": self.label,
            "chips": self.chips,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "dominant": self.dominant,
            "hlo_gflops": self.hlo_flops / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.model_roofline_fraction,
            "mem_gb_per_dev": self.per_device_memory_bytes / 1e9,
        }


def roofline(trace: Trace, hw: Hardware = H100,
             model_flops: float = 0.0) -> RooflineReport:
    """NB: under SPMD, cost_analysis() reports the *per-device* partitioned
    program, and parsed collective operand sizes are per-device too, so each
    term divides by per-chip peak only — algebraically identical to the
    global `X / (chips x peak)` formulation."""
    chips = trace.num_devices
    compute_s = trace.hlo_flops / hw.flops_bf16
    memory_s = trace.hlo_bytes / hw.hbm_bw
    coll_bytes = trace.total_collective_bytes()
    # modeled completion time (latency + bidirectional-ring bandwidth terms,
    # serialized) — finer than the naive bytes/bw division, still an upper
    # bound vs a perfectly-overlapped schedule.
    collective_s = trace.total_est_time_s()
    return RooflineReport(
        label=trace.label,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        hlo_flops=trace.hlo_flops,
        hlo_bytes=trace.hlo_bytes,
        collective_bytes=coll_bytes,
        model_flops=model_flops,
        per_device_memory_bytes=trace.per_device_memory_bytes,
        peak_flops=hw.flops_bf16,
    )


def kernel_adjusted(rf: RooflineReport, trace: Trace, scope_pattern: str,
                    new_bytes: float, new_flops: Optional[float] = None,
                    hw: Hardware = H100, label_suffix: str = "+kernel"
                    ) -> RooflineReport:
    """Roofline with one scope's XLA implementation replaced by a Pallas
    kernel's analytic traffic/FLOPs.

    The per-scope attribution (op_name metadata -> bytes_by_scope) is what
    makes this possible: e.g. replace every `attn`-scoped op's HBM traffic
    (XLA blocked attention writes scores per kv-chunk) with the flash
    kernel's q+k+v+o stream, which never spills scores.  This is the
    tracer's version of "what would this kernel buy me" — evaluated from
    the compiled artifact before writing a line of Mosaic.
    """
    import re as _re
    stats = trace.op_stats
    removed_b = sum(v for k, v in stats.bytes_by_scope.items()
                    if _re.search(scope_pattern, k))
    removed_f = sum(v for k, v in stats.flops_by_scope.items()
                    if _re.search(scope_pattern, k))
    new_hbm_bytes = max(trace.hlo_bytes - removed_b, 0.0) + new_bytes
    new_hlo_flops = trace.hlo_flops if new_flops is None else \
        max(trace.hlo_flops - removed_f, 0.0) + new_flops
    return RooflineReport(
        label=rf.label + label_suffix,
        chips=rf.chips,
        compute_s=new_hlo_flops / hw.flops_bf16,
        memory_s=new_hbm_bytes / hw.hbm_bw,
        collective_s=rf.collective_s,
        hlo_flops=new_hlo_flops,
        hlo_bytes=new_hbm_bytes,
        collective_bytes=rf.collective_bytes,
        model_flops=rf.model_flops,
        per_device_memory_bytes=rf.per_device_memory_bytes,
        peak_flops=hw.flops_bf16,
    )


def scenario_adjusted(rf: RooflineReport, result) -> RooflineReport:
    """Roofline with the collective term swapped for a what-if scenario's.

    `result` is a `whatif.ScenarioResult` over the same trace: compute
    and memory terms are untouched (a re-annotation moves no FLOPs or
    HBM bytes), the collective term and wire bytes come from the
    scenario's re-priced annotation.  The `kernel_adjusted` sibling for
    topology/protocol counterfactuals instead of Pallas kernels.
    """
    return RooflineReport(
        label=rf.label + "@" + result.scenario.name,
        chips=rf.chips,
        compute_s=rf.compute_s,
        memory_s=rf.memory_s,
        collective_s=result.est_s,
        hlo_flops=rf.hlo_flops,
        hlo_bytes=rf.hlo_bytes,
        collective_bytes=result.wire,
        model_flops=rf.model_flops,
        per_device_memory_bytes=rf.per_device_memory_bytes,
        peak_flops=rf.peak_flops,
    )


def scenario_overlay_table(rf: RooflineReport, results, top: int = 3) -> str:
    """Baseline-vs-scenarios roofline rows for dryrun output.

    One row per scenario (ranked best first, `top` shown): the modeled
    collective term under the scenario, the resulting bound, and the
    step speedup vs the baseline roofline.
    """
    lines = [f"{'configuration':36s} {'collective':>11s} {'bound':>11s} "
             f"{'dominant':>10s} {'speedup':>8s}"]
    lines.append(f"{rf.label:36s} {rf.collective_s*1e3:10.2f}m "
                 f"{rf.bound_s*1e3:10.2f}m {rf.dominant:>10s} "
                 f"{'1.00x':>8s}")
    for r in results[:top]:
        adj = scenario_adjusted(rf, r)
        speed = rf.bound_s / adj.bound_s if adj.bound_s else float("inf")
        lines.append(f"{adj.label:36s} {adj.collective_s*1e3:10.2f}m "
                     f"{adj.bound_s*1e3:10.2f}m {adj.dominant:>10s} "
                     f"{speed:7.2f}x")
    return "\n".join(lines)


def scope_breakdown(trace: Trace, top: int = 12) -> str:
    """Per-scope bytes/FLOPs table (profiling view for the perf loop)."""
    stats = trace.op_stats
    scopes = sorted(stats.bytes_by_scope,
                    key=lambda k: -stats.bytes_by_scope[k])[:top]
    lines = [f"{'scope':52s} {'GB':>10s} {'GFLOP':>10s}"]
    for s in scopes:
        lines.append(f"{(s or '(unscoped)'):52s} "
                     f"{stats.bytes_by_scope[s]/1e9:10.2f} "
                     f"{stats.flops_by_scope.get(s, 0.0)/1e9:10.1f}")
    return "\n".join(lines)


def train_model_flops(n_params: int, n_tokens: int) -> float:
    """6 N D (dense) — pass active params for MoE."""
    return 6.0 * n_params * n_tokens


def decode_model_flops(n_params: int, n_tokens: int) -> float:
    """2 N per generated token (fwd only)."""
    return 2.0 * n_params * n_tokens
