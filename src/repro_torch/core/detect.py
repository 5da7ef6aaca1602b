"""Findings and their ranking (the part of the reference's `core/detect.py`
that the sharding lint needs).  The dynamic detectors, which read a trace,
come with the profiler's back half.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

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
        """Inverse of `to_dict` (watch-daemon checkpoint restore).

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
