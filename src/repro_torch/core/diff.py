"""Trace diffing — the before/after workflow of the paper's case studies
(a copy of the reference's `core/diff.py`, columnar engine only).

ucTrace's users compare runs (eager vs rndv configs, NUMA-aware vs not,
OMPI vs MPICH).  `diff_traces` aligns two traces by traffic class and
reports byte/count/time deltas, new/vanished classes, and a verdict line
per class — so "what did my change do to communication?" is one function
call on two compiled artifacts.

`diff_n` generalizes the alignment to N traces (the paper's "Allreduce
across MPI libraries / UCX settings" shape): one row per traffic class,
one column per trace, rendered by `report.session_table`.

Alignment is *code-aligned* by default: every trace rolls up once over
its interned categorical codes, the per-trace label tables are merged
into one union vocabulary (`store.union_rollup`), and bytes/count/time
scatter into a `(n_keys, n_traces)` matrix — no string-keyed dicts on
the N-trace hot path, so session diffs stay cheap at 100k+ sites.  (The
reference also keeps a per-event dict walk, `engine="rows"`; the port's
rows are held equal to the reference's columnar ones by
tests/test_torch_backhalf.py.)

Besides the class-level keys, `by="site"` aligns on the interned
op_name x kind x axes triple — one row per compiled callsite class —
so a regression shows up against the op_name that produced it instead
of washing out in a kind x link rollup.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import Trace, site_key
from repro_torch.core.store import union_rollup

# per-event key functions, one per alignment mode (the keys
# `TraceStore._codes_for` rolls up by, label for label)
KEY_FNS = {
    "kind_link": lambda e: f"{e.kind}|{e.link_class}",
    "semantic": lambda e: e.semantic or "other",
    "site": site_key,
    "sem_kind_link": lambda e: f"{e.semantic}|{e.kind}|{e.link_class}",
}


def _norm_by(by: str) -> str:
    # historic behavior: any unknown key meant the 3-way class rollup
    return by if by in KEY_FNS else "sem_kind_link"


def _aligned(traces: Sequence[Trace], by: str
             ) -> Tuple[List[str], np.ndarray]:
    """Union keys (alphabetical) + (4, n_keys, n_traces) metric tensor.

    Alphabetical key order, so a stable sort by any metric afterwards ties
    off deterministically.
    """
    union, mats = union_rollup([t.store for t in traces], _norm_by(by))
    if not union:
        return [], mats
    order = np.argsort(np.asarray(union))
    return [union[int(i)] for i in order], mats[:, order, :]


@dataclass
class DiffRow:
    key: str
    bytes_a: float
    bytes_b: float
    count_a: float
    count_b: float
    time_a: float
    time_b: float

    @property
    def bytes_ratio(self) -> float:
        if self.bytes_a == 0:
            return float("inf") if self.bytes_b else 1.0
        return self.bytes_b / self.bytes_a

    def verdict(self, threshold: float = 0.1) -> str:
        r = self.bytes_ratio
        if self.bytes_a == 0 and self.bytes_b > 0:
            return "NEW"
        if self.bytes_b == 0 and self.bytes_a > 0:
            return "GONE"
        if r > 1 + threshold:
            return f"GREW {r:.2f}x"
        if r < 1 - threshold:
            return f"SHRANK {1/r:.2f}x"
        return "~same"


def diff_traces(a: Trace, b: Trace, by: str = "kind_link") -> List[DiffRow]:
    """Align two traces by traffic class, sorted by |byte delta|."""
    keys, mats = _aligned((a, b), by)
    if not keys:
        return []
    bm, cm, tm = mats[0], mats[2], mats[3]
    order = np.argsort(-np.abs(bm[:, 1] - bm[:, 0]), kind="stable")
    return [DiffRow(keys[i], float(bm[i, 0]), float(bm[i, 1]),
                    float(cm[i, 0]), float(cm[i, 1]),
                    float(tm[i, 0]), float(tm[i, 1]))
            for i in (int(j) for j in order)]


def _filter_rows(rows: List[DiffRow], top: Optional[int] = None,
                 only_regressed: bool = False) -> List[DiffRow]:
    """Row filter shared by the rendered and JSON diff outputs.

    `only_regressed` keeps classes that grew past the verdict threshold
    or are new in B; `top` then truncates to the N largest |byte delta|
    (the rows are already delta-sorted by `diff_traces`).
    """
    if only_regressed:
        rows = [r for r in rows
                if r.verdict() == "NEW" or r.verdict().startswith("GREW")]
    if top is not None:
        rows = rows[:max(top, 0)]
    return rows


def diff_json(a: Trace, b: Trace, by: str = "kind_link",
              top: Optional[int] = None,
              only_regressed: bool = False,
              extra: Optional[Dict[str, object]] = None
              ) -> Dict[str, object]:
    """Machine-readable pairwise diff (the tooling-facing sibling of
    `render_diff`): one dict per aligned row plus modeled-time totals.

    `bytes_ratio` is `null` for rows new in B (the rendered verdict says
    NEW; infinity is not valid JSON).  `extra`, when given, lands under
    a `slice` key — the session layer uses it to record the fleet slice
    specs each side was merged from.
    """
    rows = _filter_rows(diff_traces(a, b, by), top, only_regressed)
    ta, tb = a.total_est_time_s(), b.total_est_time_s()
    payload: Dict[str, object] = {
        "a": a.label,
        "b": b.label,
        "by": _norm_by(by),
        "top": top,
        "only_regressed": only_regressed,
        "total_time_a_s": ta,
        "total_time_b_s": tb,
        "rows": [{
            "key": r.key,
            "bytes_a": r.bytes_a, "bytes_b": r.bytes_b,
            "count_a": r.count_a, "count_b": r.count_b,
            "time_a_s": r.time_a, "time_b_s": r.time_b,
            "bytes_ratio": None if (r.bytes_a == 0 and r.bytes_b > 0)
            else r.bytes_ratio,
            "verdict": r.verdict(),
        } for r in rows],
    }
    if extra is not None:
        payload["slice"] = extra
    return payload


def render_diff(a: Trace, b: Trace, by: str = "kind_link",
                top: Optional[int] = None,
                only_regressed: bool = False) -> str:
    rows = _filter_rows(diff_traces(a, b, by), top, only_regressed)
    mode = by + (", regressed only" if only_regressed else "") \
        + (f", top {top}" if top is not None else "")
    lines = [f"trace diff: '{a.label}' -> '{b.label}'  (by {mode})",
             f"{'key':42s} {'GB a':>9s} {'GB b':>9s} {'cnt a':>7s} "
             f"{'cnt b':>7s} {'ms a':>8s} {'ms b':>8s}  verdict"]
    for r in rows:
        lines.append(
            f"{r.key:42s} {r.bytes_a/1e9:9.3f} {r.bytes_b/1e9:9.3f} "
            f"{int(r.count_a):7d} {int(r.count_b):7d} "
            f"{r.time_a*1e3:8.2f} {r.time_b*1e3:8.2f}  {r.verdict()}")
    ta, tb = a.total_est_time_s(), b.total_est_time_s()
    lines.append(f"{'TOTAL modeled collective time':42s} "
                 f"{'':9s} {'':9s} {'':7s} {'':7s} "
                 f"{ta*1e3:8.2f} {tb*1e3:8.2f}  "
                 f"{'%.2fx' % (tb/ta) if ta else 'n/a'}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# n-way alignment (session comparisons)
# --------------------------------------------------------------------------

@dataclass
class NWayRow:
    """One traffic class aligned across N traces."""

    key: str
    bytes_: List[float]
    counts: List[float]
    times: List[float]

    @property
    def max_bytes(self) -> float:
        return max(self.bytes_)

    @property
    def spread(self) -> float:
        """max/min byte ratio over traces where the class exists (>=1)."""
        present = [b for b in self.bytes_ if b > 0]
        if not present:
            return 1.0
        return max(present) / min(present)

    def verdict(self, threshold: float = 0.1) -> str:
        present = sum(1 for b in self.bytes_ if b > 0)
        if present < len(self.bytes_):
            return f"in {present}/{len(self.bytes_)}"
        r = self.spread
        return f"varies {r:.2f}x" if r > 1 + threshold else "~same"


def diff_n(traces: Sequence[Trace], by: str = "kind_link") -> List[NWayRow]:
    """Align N traces by traffic class; rows sorted by peak bytes."""
    traces = list(traces)
    if not traces:
        return []
    keys, mats = _aligned(traces, by)
    if not keys:
        return []
    bm, cm, tm = mats[0], mats[2], mats[3]
    order = np.argsort(-bm.max(axis=1), kind="stable")
    return [NWayRow(key=keys[i], bytes_=bm[i].tolist(),
                    counts=cm[i].tolist(), times=tm[i].tolist())
            for i in (int(j) for j in order)]
