"""commcheck — static collective-correctness analysis over `TraceStore`
(a copy of the reference's `core/commcheck.py`, its streaming
`CommcheckState` included; risk is priced on the H100 model when a store
arrives unpriced).

Everything else in the tracer is *dynamic*: detectors fire after a trace
is ingested and priced.  This module is the static pass — it verifies the
collective communication structure of a compiled (or synthetic) program
without executing anything, in the spirit of the cross-layer validation
the INAM-style cluster profilers run post-hoc.  A malformed collective
that would surface as a hang on real hardware becomes a ranked diagnostic
at lint time.

Four analysis families:

  1. **match / deadlock analysis** (`check_matches`) — sites sharing a
     `channel_id` claim to be one collective instance stream (XLA channel
     semantics).  The port's capture records no channel ids
     (`channel_id = -1`: a c10d collective carries none), so on its own
     traces every site is a singleton class and only `group_coverage` can
     fire; the channel classes run on sessions loaded from the reference's
     files and on `synth.inject_comm_bugs`.  Per match class we flag: channel reuse across different
     collective kinds (`channel_collision`), payload shape/dtype
     disagreement within a matched class (`shape_mismatch`), devices left
     out of every group of the class (`group_coverage`), and — over the
     cross-device match graph (devices connected by shared groups) —
     participants that disagree on *how many* instances they execute
     (`deadlock_order`): the ranks expecting the extra instance block
     forever, the classic mismatched-collective-ordering deadlock.
  2. **replica-group validation** (`check_replica_groups`) — per unique
     group table: device ids outside the mesh (`device_out_of_range`),
     a device in more than one group of the same collective
     (`group_overlap`), group sizes inconsistent with the mesh axes they
     span (`group_mesh_mismatch`), and degenerate all-size-1 groups that
     move no data (`degenerate_group`).  Permute pair lists get the
     analogous checks (`check_permutes`).
  3. **sharding-spec lint** (`lint_pspecs`) — pre-trace validation of
     PartitionSpec trees against the mesh: an axis used twice in one spec
     (`pspec_dup_axis`), spec axes absent from the mesh
     (`pspec_unknown_axis`), dims not divisible by their axis product
     (`pspec_indivisible`), and unsharded dominant dims while mesh axes
     sit idle (`pspec_unsharded_dim`).  Duck-typed over anything that
     iterates like a PartitionSpec (the port's specs are plain tuples).
  4. **severity ranking** — every finding carries the cost-model
     wire-bytes / est-time at risk of the implicated sites
     (`costmodel.annotate_store` fills the columns), and `check_trace`
     returns `detect.rank_findings` order: critical > warn > info,
     largest bytes at risk first.

Vectorization: the per-site work is numpy over interned codes — group
tables expand once per *unique* table (`store.expand_groups`), coverage
is one scatter (`store.table_device_counts`), match classes come from one
`np.unique` over the channel column.  Python loops run only over unique
tables and multi-site match classes (a handful each in real modules),
never over events.

Finding codes are stable: `session lint --json` emits
`Finding.to_dict()` — the same schema as `session detect --json`.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.detect import Finding, rank_findings
from repro_torch.core.events import Trace
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec, varying_axes

__all__ = [
    "check_trace", "check_store", "check_replica_groups", "check_matches",
    "check_permutes", "lint_pspecs", "findings_json",
]


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _risk(store: TraceStore, rows: np.ndarray) -> Dict[str, float]:
    """Cost-model weight of the implicated rows (wire bytes, est time)."""
    rows = np.asarray(rows, dtype=np.int64)
    w = store.weights[rows]
    return {
        "wasted_bytes": float((store.wire_total[rows] * w).sum()),
        "time_at_risk_s": float((store.est_time_s[rows] * w).sum()),
    }


# fix advice per finding code.  Static findings are correctness bugs, so
# the quantification is the modeled step time the implicated collectives
# account for (`time_at_risk_s`) — what the fix unblocks — rather than a
# counterfactual re-pricing (`whatif` quantifies the dynamic detectors).
_ADVICE: Dict[str, str] = {
    "device_out_of_range": "fix the replica groups to index devices that "
                           "exist in the mesh",
    "group_overlap": "make the replica groups of each collective disjoint",
    "degenerate_group": "delete the collective or widen its groups — "
                        "size-1 groups move no data",
    "group_mesh_mismatch": "retile the replica groups so each evenly "
                           "covers the mesh axes it spans",
    "group_coverage": "include every device in a replica group (SPMD runs "
                      "the op on all ranks)",
    "channel_collision": "give each collective instance its own channel id",
    "shape_mismatch": "make matched participants agree on payload "
                      "shape/dtype",
    "deadlock_order": "align the collective call order across ranks",
    "permute_dup_target": "route at most one source to each permute target",
    "permute_dup_source": "check the intended ring/shift pattern "
                          "(multicast source)",
    "permute_self_loop": "drop the self-loop pairs — they move no data",
    "pspec_dup_axis": "use each mesh axis in at most one dim of the spec",
    "pspec_unknown_axis": "name only axes the mesh defines",
    "pspec_indivisible": "pad the dim or pick axes whose product divides it",
    "pspec_unsharded_dim": "shard the dominant dim over the idle axes",
}


def _advise(findings: List[Finding]) -> List[Finding]:
    """Attach the fix advice + unblocked-time figure to each finding."""
    from repro_torch.core.whatif import fmt_time
    for f in findings:
        if f.recommendation:
            continue
        advice = _ADVICE.get(f.detector)
        if advice is None:
            continue
        f.est_saved_s = f.time_at_risk_s
        f.recommendation = advice if f.time_at_risk_s == 0 else \
            f"{advice} — unblocks est {fmt_time(f.time_at_risk_s)}/step"
    return findings


def _first_row_per_code(codes: np.ndarray, rows: np.ndarray,
                        n_codes: int) -> np.ndarray:
    """First row index using each code (-1 = unused), one reverse scatter."""
    first = np.full(n_codes, -1, dtype=np.int64)
    if len(rows):
        first[codes[::-1]] = rows[::-1]
    return first


def _fmt_devices(devs: Sequence[int], limit: int = 8) -> str:
    devs = [int(d) for d in devs]
    body = ", ".join(map(str, devs[:limit]))
    return body + (", ..." if len(devs) > limit else "")


def _axis_prod(mesh: MeshSpec, axes: Tuple[str, ...]) -> int:
    p = 1
    for a in axes:
        p *= mesh.shape[mesh.axes.index(a)]
    return p


def _table_counts(table, nd: int) -> np.ndarray:
    """Per-device appearance counts of one group table (value-based
    sibling of `store.table_device_counts`; out-of-range ids dropped)."""
    counts = np.zeros(nd, dtype=np.int64)
    for g in table:
        for d in g:
            d = int(d)
            if 0 <= d < nd:
                counts[d] += 1
    return counts


# --------------------------------------------------------------------------
# per-unit analysis bodies — computed from table *values*, so the batch
# checkers below and the streaming `CommcheckState` produce identical
# findings for the same unit regardless of which store's codes carried it
# --------------------------------------------------------------------------

def _group_table_finding(table, mesh: MeshSpec, sites: int,
                         kw: Dict) -> Optional[Finding]:
    """Structural verdict on one unique replica-group table (<= 1 finding)."""
    nd = mesh.num_devices
    flat = [int(d) for g in table for d in g]
    bad = sorted({d for d in flat if d < 0 or d >= nd})
    if bad:
        return Finding(
            "device_out_of_range", "critical",
            f"replica groups at {sites} site(s) name device(s) "
            f"[{_fmt_devices(bad)}] outside the {nd}-device mesh", **kw)
    seen: Dict[int, int] = {}
    for d in flat:
        seen[d] = seen.get(d, 0) + 1
    dups = sorted(d for d, c in seen.items() if c > 1)
    if dups:
        return Finding(
            "group_overlap", "critical",
            f"device(s) [{_fmt_devices(dups)}] appear in more than one "
            f"replica group of the same collective at {sites} site(s) — "
            f"groups must be disjoint", **kw)
    sizes = sorted({len(g) for g in table})
    if sizes and sizes[-1] <= 1:
        return Finding(
            "degenerate_group", "info",
            f"all replica groups are size 1 at {sites} site(s) — the "
            f"collective moves no data (dead comm)", **kw)
    if len(sizes) > 1:
        return Finding(
            "group_mesh_mismatch", "warn",
            f"ragged replica groups (sizes {sizes}) at {sites} site(s) "
            f"— the groups of one collective should tile the mesh "
            f"uniformly", **kw)
    # uniform sizes: each group must evenly tile the axes it spans
    bad_groups = 0
    example: Tuple[str, ...] = ()
    for g in table:
        if len(g) <= 1:
            continue
        va = varying_axes(mesh, g)
        if _axis_prod(mesh, va) % len(g):
            bad_groups += 1
            example = va
    if bad_groups:
        return Finding(
            "group_mesh_mismatch", "warn",
            f"{bad_groups}/{len(table)} replica group(s) of size "
            f"{sizes[0]} at {sites} site(s) do not evenly tile the mesh "
            f"axes they span {example} — group sizes should divide the "
            f"spanned axis product", **kw)
    return None


def _permute_table_findings(pairs, nd: int, sites: int,
                            kw: Dict) -> List[Finding]:
    """Range / fan-in / fan-out / self-loop checks on one pair table."""
    out: List[Finding] = []
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if ((pairs < 0) | (pairs >= nd)).any():
        bad = np.unique(pairs[(pairs < 0) | (pairs >= nd)])
        out.append(Finding(
            "device_out_of_range", "critical",
            f"collective-permute pairs at {sites} site(s) name "
            f"device(s) [{_fmt_devices(bad)}] outside the {nd}-device "
            f"mesh", **kw))
        return out
    src, dst = pairs[:, 0], pairs[:, 1]
    if len(np.unique(dst)) < len(dst):
        out.append(Finding(
            "permute_dup_target", "critical",
            f"collective-permute at {sites} site(s) lists a target "
            f"device more than once — two sources write the same "
            f"destination buffer", **kw))
    elif len(np.unique(src)) < len(src):
        out.append(Finding(
            "permute_dup_source", "warn",
            f"collective-permute at {sites} site(s) sends from the "
            f"same source more than once (multicast) — check the "
            f"intended ring/shift pattern", **kw))
    n_self = int((src == dst).sum())
    if n_self:
        out.append(Finding(
            "permute_self_loop", "info",
            f"{n_self} self-loop pair(s) in a collective-permute at "
            f"{sites} site(s) — those transfers move no data", **kw))
    return out


def _f_coverage_singleton(sites: int, missing, nd: int, **kw) -> Finding:
    return Finding(
        "group_coverage", "critical",
        f"{sites} collective site(s) leave {len(missing)} of "
        f"{nd} devices out of every replica group (missing: "
        f"[{_fmt_devices(missing)}]) — in SPMD every device "
        f"executes the op, so the excluded ranks hang", **kw)


def _class_findings(chan: int, members: Sequence[Tuple],
                    tables: Dict, mesh: MeshSpec, kw: Dict) -> List[Finding]:
    """Signature + match-graph checks on one multi-site channel class.

    `members` are `(kind, bytes, dtype, multiplicity, table_key)` value
    tuples in row order; `tables` maps each referenced table key to the
    table itself.
    """
    out: List[Finding] = []
    nd = mesh.num_devices
    kind_names = {m[0] for m in members}
    if len(kind_names) > 1:
        names = sorted(kind_names)
        out.append(Finding(
            "channel_collision", "critical",
            f"channel {chan} is reused by {len(members)} sites of "
            f"different collective kinds ({', '.join(names)}) — a "
            f"channel id must identify one collective instance", **kw))
        return out
    kind = members[0][0]
    sigs = {(m[1], m[2]) for m in members}
    if len(sigs) > 1:
        blist = sorted({b for b, _ in sigs})
        dlist = sorted({d for _, d in sigs})
        out.append(Finding(
            "shape_mismatch", "critical",
            f"sites matched on channel {chan} disagree on payload "
            f"shape/dtype (bytes {blist}, dtypes {dlist}) — matched "
            f"{kind} participants must agree elementwise", **kw))
        return out
    # per-device instance counts across the class
    counts = np.zeros(nd, dtype=np.int64)
    cnt_by_key = {key: _table_counts(t, nd) for key, t in tables.items()}
    for m in members:
        counts += m[3] * cnt_by_key[m[4]]
    if (counts == 0).any():
        missing = np.flatnonzero(counts == 0)
        out.append(Finding(
            "group_coverage", "critical",
            f"{len(missing)} of {nd} devices never participate in any "
            f"{kind} on channel {chan} (missing: "
            f"[{_fmt_devices(missing)}]) — the excluded ranks hang",
            **kw))
    if len(tables) > 1:
        # match graph: devices sharing a group are matched partners
        uf = _UnionFind(nd)
        for t in tables.values():
            for g in t:
                ok = [int(d) for d in g if 0 <= int(d) < nd]
                for d in ok[1:]:
                    uf.union(ok[0], d)
        comps: Dict[int, List[int]] = {}
        for d in np.flatnonzero(counts > 0):
            comps.setdefault(uf.find(int(d)), []).append(int(d))
        for comp in comps.values():
            cs = counts[comp]
            lo, hi = int(cs.min()), int(cs.max())
            if lo != hi:
                out.append(Finding(
                    "deadlock_order", "critical",
                    f"devices matched on channel {chan} disagree on how "
                    f"many {kind} instances they execute ({lo} vs {hi} "
                    f"across {len(comp)} connected devices) — the "
                    f"ranks expecting the extra instance block forever "
                    f"(mismatched collective ordering)", **kw))
                break
    return out


# --------------------------------------------------------------------------
# family 2: replica-group validation (per unique table)
# --------------------------------------------------------------------------

def check_replica_groups(store: TraceStore, mesh: MeshSpec) -> List[Finding]:
    """Structural validity of every unique replica-group table in use.

    Permute rows are excluded — their group attr is the parser's
    full-range fallback; their real participants (the pair lists) are
    validated by `check_permutes`.
    """
    out: List[Finding] = []
    if store.n == 0 or not store.group_tables:
        return out
    nd = mesh.num_devices
    n_tables = len(store.group_tables)
    ring = store.stp_code < 0
    ring_rows = np.flatnonzero(ring)
    gc = store.group_code[ring_rows]
    w = (store.wire_total * store.weights)
    t_s = (store.est_time_s * store.weights)
    wb = np.bincount(gc, weights=w[ring_rows], minlength=n_tables)
    ts = np.bincount(gc, weights=t_s[ring_rows], minlength=n_tables)
    nrows = np.bincount(gc, minlength=n_tables)
    first = _first_row_per_code(gc, ring_rows, n_tables)

    for t in range(n_tables):
        if nrows[t] == 0:
            continue
        kw = dict(wasted_bytes=float(wb[t]), time_at_risk_s=float(ts[t]),
                  site=store.names[first[t]] if first[t] >= 0 else f"groups#{t}")
        f = _group_table_finding(store.group_tables[t], mesh,
                                 int(nrows[t]), kw)
        if f is not None:
            out.append(f)
    return out


# --------------------------------------------------------------------------
# family 1: match / deadlock analysis (per channel match class)
# --------------------------------------------------------------------------

def _match_classes(store: TraceStore, rows: np.ndarray
                   ) -> Iterator[Tuple[int, np.ndarray]]:
    """(channel, member rows) for every channel shared by >= 2 sites."""
    ch = store.channel_id[rows]
    order = rows[np.argsort(ch, kind="stable")]
    chs = store.channel_id[order]
    uch, start, counts = np.unique(chs, return_index=True, return_counts=True)
    for i in np.flatnonzero(counts > 1):
        yield int(uch[i]), order[start[i]:start[i] + counts[i]]


class _UnionFind:
    """Tiny union-find over device ids (mesh-sized, not event-sized)."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def check_matches(store: TraceStore, mesh: MeshSpec) -> List[Finding]:
    """Channel-keyed match analysis: collision, shape, coverage, deadlock.

    Sites sharing a `channel_id` form one match class (XLA channel
    semantics: the channel identifies a collective instance stream).
    Sites without a channel — or with a unique one — are their own class;
    for those, coverage is the only applicable check and runs vectorized.
    Multi-site classes (rare) additionally get the signature and
    match-graph checks in a per-class loop.
    """
    out: List[Finding] = []
    if store.n == 0:
        return out
    nd = mesh.num_devices
    ring_rows = np.flatnonzero(store.stp_code < 0)
    if not len(ring_rows):
        return out
    cnt_t = store.table_device_counts(nd)
    present_t = cnt_t > 0
    miss_t = nd - present_t.sum(axis=1)

    chan_rows = ring_rows[store.channel_id[ring_rows] >= 0]
    multi: List[Tuple[int, np.ndarray]] = list(_match_classes(store, chan_rows))
    in_multi = np.zeros(store.n, dtype=bool)
    for _c, rows in multi:
        in_multi[rows] = True
    single = ring_rows[~in_multi[ring_rows]]

    # -- singleton classes: vectorized per-site coverage --------------------
    if len(single):
        bad = single[miss_t[store.group_code[single]] > 0]
        for t in np.unique(store.group_code[bad]):
            rows_t = bad[store.group_code[bad] == t]
            missing = np.flatnonzero(~present_t[t])
            out.append(_f_coverage_singleton(
                len(rows_t), missing, nd,
                site=store.names[int(rows_t[0])], **_risk(store, rows_t)))

    # -- multi-site classes: signature + match-graph checks -----------------
    for chan, rows in multi:
        kw = dict(site=f"channel {chan}", **_risk(store, rows))
        members = [(store.kind.value(int(r)), int(store.operand_bytes[r]),
                    store.dtype.value(int(r)), int(store.multiplicity[r]),
                    int(store.group_code[r])) for r in rows]
        tables = {}
        for m in members:
            tables.setdefault(m[4], store.group_tables[m[4]])
        out += _class_findings(chan, members, tables, mesh, kw)
    return out


# --------------------------------------------------------------------------
# permute pair validation
# --------------------------------------------------------------------------

def check_permutes(store: TraceStore, mesh: MeshSpec) -> List[Finding]:
    """Per unique source/target pair table: range, fan-in/out, self-loops."""
    out: List[Finding] = []
    if store.n == 0 or not store.stp_tables:
        return out
    nd = mesh.num_devices
    n_t = len(store.stp_tables)
    rows_m = np.flatnonzero(store.stp_code >= 0)
    sc = store.stp_code[rows_m]
    w = store.wire_total * store.weights
    t_s = store.est_time_s * store.weights
    wb = np.bincount(sc, weights=w[rows_m], minlength=n_t)
    ts = np.bincount(sc, weights=t_s[rows_m], minlength=n_t)
    nrows = np.bincount(sc, minlength=n_t)
    first = _first_row_per_code(sc, rows_m, n_t)
    for t in range(n_t):
        if nrows[t] == 0:
            continue
        kw = dict(wasted_bytes=float(wb[t]), time_at_risk_s=float(ts[t]),
                  site=store.names[first[t]] if first[t] >= 0 else f"pairs#{t}")
        out += _permute_table_findings(store.stp_tables[t], nd,
                                       int(nrows[t]), kw)
    return out


# --------------------------------------------------------------------------
# family 3: sharding-spec lint (pre-trace, duck-typed PartitionSpecs)
# --------------------------------------------------------------------------

def _default_is_leaf(x) -> bool:
    return type(x).__name__ == "PartitionSpec"


def _walk_specs(tree, shapes, path: str, is_leaf):
    if tree is None:
        return
    if is_leaf(tree):
        yield path, tree, shapes
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub = shapes.get(k) if isinstance(shapes, dict) else None
            yield from _walk_specs(v, sub, f"{path}/{k}" if path else str(k),
                                   is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = shapes[i] if isinstance(shapes, (list, tuple)) \
                and i < len(shapes) else None
            yield from _walk_specs(v, sub, f"{path}/{i}" if path else str(i),
                                   is_leaf)
    else:
        # unknown leaf type: treat as spec-like (iterable of entries)
        yield path, tree, shapes


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def lint_pspecs(pspecs, axis_sizes: Dict[str, int], shapes=None, *,
                big_dim: int = 4096, is_leaf=None,
                prefix: str = "") -> List[Finding]:
    """Statically validate a PartitionSpec tree against mesh axis sizes.

    `pspecs` is any nesting of dict/list/tuple with PartitionSpec-like
    leaves (anything iterating as `None | str | tuple[str, ...]` entries
    — duck-typed, so plain tuples work via `is_leaf`).
    `shapes`, when given, mirrors the tree with per-leaf dim tuples and
    enables the divisibility and unsharded-dominant-dim checks.
    `wasted_bytes` ranks spec findings by f32 tensor bytes at stake.
    """
    if is_leaf is None:
        is_leaf = _default_is_leaf
    out: List[Finding] = []
    for path, spec, shape in _walk_specs(pspecs, shapes, prefix, is_leaf):
        entries = list(spec)
        per_dim = [_entry_axes(e) for e in entries]
        used = [a for axes in per_dim for a in axes]
        weight = float(np.prod(shape)) * 4.0 if shape else 0.0
        kw = dict(site=path or "<spec>", wasted_bytes=weight)
        dups = sorted({a for a in used if used.count(a) > 1})
        if dups:
            out.append(Finding(
                "pspec_dup_axis", "critical",
                f"PartitionSpec{tuple(entries)} uses mesh axis(es) {dups} "
                f"in more than one dim — an axis can shard only one dim",
                **kw))
        unknown = sorted({a for a in used if a not in axis_sizes})
        if unknown:
            out.append(Finding(
                "pspec_unknown_axis", "critical",
                f"PartitionSpec{tuple(entries)} names mesh axis(es) "
                f"{unknown} absent from the mesh "
                f"(have {sorted(axis_sizes)})", **kw))
            continue
        if not shape:
            continue
        for d, (dim, axes) in enumerate(zip(shape, per_dim)):
            prod = int(np.prod([axis_sizes[a] for a in axes])) if axes else 1
            if axes and prod and dim % prod:
                out.append(Finding(
                    "pspec_indivisible", "warn",
                    f"dim {d} (size {dim}) of PartitionSpec{tuple(entries)} "
                    f"is not divisible by its axis product {prod} "
                    f"({'x'.join(axes)}) — the rules fall back to "
                    f"replication", **kw))
        idle = [a for a, s in axis_sizes.items() if s > 1 and a not in used]
        if idle and len(shape) > len([a for a in per_dim if a]) - 1:
            big = max(range(len(shape)), key=lambda i: shape[i],
                      default=None)
            if big is not None and shape[big] >= big_dim \
                    and (big >= len(per_dim) or not per_dim[big]):
                out.append(Finding(
                    "pspec_unsharded_dim", "warn",
                    f"dominant dim {big} (size {shape[big]}) of "
                    f"PartitionSpec{tuple(entries)} is unsharded while mesh "
                    f"axis(es) {sorted(idle)} sit idle — shard it or accept "
                    f"the replicated memory/traffic", **kw))
    return _advise(out)


def findings_json(findings: Sequence[Finding]) -> List[Dict[str, object]]:
    """The stable machine schema (shared with `session detect --json`)."""
    return [f.to_dict() for f in findings]


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def check_store(store: TraceStore, mesh: MeshSpec) -> List[Finding]:
    """All trace-level families over one columnar store (unranked)."""
    return _advise(check_replica_groups(store, mesh)
                   + check_matches(store, mesh)
                   + check_permutes(store, mesh))


def check_trace(trace: Trace, mesh: Optional[MeshSpec] = None,
                hw: Hardware = H100) -> List[Finding]:
    """Static analysis of one trace, ranked by severity then bytes at risk.

    Annotates the store through `costmodel.annotate_store` first when the
    cost columns are empty (a store ingested without annotation), so the
    ranking weight is available; traces from the normal pipelines are
    already priced and pass through untouched.
    """
    if mesh is None:
        mesh = MeshSpec(tuple(trace.mesh_shape), tuple(trace.mesh_axes))
    store = trace.store
    if store.n and not store.wire_bytes_per_device.any():
        try:
            costmodel.annotate_store(store, mesh, hw)
        except (ValueError, IndexError, KeyError):
            pass    # un-annotatable (e.g. out-of-range devices): rank by 0
    return rank_findings(check_store(store, mesh))


# --------------------------------------------------------------------------
# streaming analysis — fold appended chunks, re-render fresh findings
# --------------------------------------------------------------------------

class CommcheckState:
    """Streaming `check_store`: absorb ingested chunks, render on demand.

    `update(store)` folds one (annotated) chunk in; `findings()` then
    returns the ranked findings a batch `check_trace` would produce over
    the union of all chunks seen so far.  Retained state is
    compiled-program-shaped: unique group/pair tables with per-table
    site/risk sums, plus one small member record per channel-carrying
    row — channel match classes cannot be collapsed early because a
    later chunk may add members that flip a singleton into a multi-site
    class.  The analysis bodies (`_group_table_finding`,
    `_class_findings`, `_permute_table_findings`) are shared with the
    batch checkers, so messages are string-identical; accumulated risk
    sums group per chunk and are close, not bitwise-equal, to one batch
    pass.
    """

    def __init__(self, mesh: MeshSpec):
        self.mesh = mesh
        self._off = 0    # global row offset across chunks
        # value-key -> table, insertion order == the union store's
        # first-seen table code order (chunks intern in row order, and
        # we fold chunk tables in their code order, exactly like merge)
        self._gtables: Dict[Tuple, List] = {}
        self._ptables: Dict[Tuple, List] = {}
        self._gstat: Dict[Tuple, Dict] = {}     # ring rows per group table
        self._pstat: Dict[Tuple, Dict] = {}     # permute rows per pair table
        self._nochan: Dict[Tuple, Dict] = {}    # channel-less ring rows
        self._chan: Dict[int, List[Dict]] = {}  # channel -> member records

    @staticmethod
    def _fold(stat: Dict[Tuple, Dict], key: Tuple, sites: int, wb: float,
              ts: float, first: Optional[Tuple[int, str]]) -> None:
        st = stat.setdefault(key, {"sites": 0, "wb": 0.0, "ts": 0.0,
                                   "first": None})
        st["sites"] += sites
        st["wb"] += wb
        st["ts"] += ts
        if first is not None and (st["first"] is None
                                  or first < st["first"]):
            st["first"] = first

    def update(self, store: TraceStore) -> None:
        gkeys = []
        for table in store.group_tables:
            key = tuple(tuple(int(x) for x in g) for g in table)
            self._gtables.setdefault(key, table)
            gkeys.append(key)
        pkeys = []
        for t in store.stp_tables:
            key = tuple((int(a), int(b)) for a, b in t)
            self._ptables.setdefault(key, t)
            pkeys.append(key)
        if store.n == 0:
            return
        w = store.wire_total * store.weights
        t_s = store.est_time_s * store.weights
        ring_rows = np.flatnonzero(store.stp_code < 0)
        stp_rows = np.flatnonzero(store.stp_code >= 0)

        def fold_rows(stat, rows, code, keys):
            n_t = len(keys)
            if not n_t or not len(rows):
                return
            c = code[rows]
            wb = np.bincount(c, weights=w[rows], minlength=n_t)
            ts = np.bincount(c, weights=t_s[rows], minlength=n_t)
            nrows = np.bincount(c, minlength=n_t)
            first = _first_row_per_code(c, rows, n_t)
            for t in np.flatnonzero(nrows):
                fi = int(first[t])
                self._fold(stat, keys[t], int(nrows[t]), float(wb[t]),
                           float(ts[t]),
                           (self._off + fi, store.names[fi]))

        fold_rows(self._gstat, ring_rows, store.group_code, gkeys)
        fold_rows(self._pstat, stp_rows, store.stp_code, pkeys)

        ch = store.channel_id
        chan_rows = ring_rows[ch[ring_rows] >= 0]
        for r in chan_rows.tolist():
            self._chan.setdefault(int(ch[r]), []).append({
                "kind": store.kind.value(r),
                "bytes": int(store.operand_bytes[r]),
                "dtype": store.dtype.value(r),
                "mult": int(store.multiplicity[r]),
                "table": gkeys[store.group_code[r]],
                "wb": float(w[r]), "ts": float(t_s[r]),
                "gidx": self._off + r, "name": store.names[r]})
        nochan_rows = ring_rows[ch[ring_rows] < 0]
        fold_rows(self._nochan, nochan_rows, store.group_code, gkeys)
        self._off += store.n

    def findings(self) -> List[Finding]:
        mesh = self.mesh
        nd = mesh.num_devices
        out: List[Finding] = []
        # family 2: replica-group structure, in union table order
        for key, table in self._gtables.items():
            st = self._gstat.get(key)
            if not st:
                continue
            kw = dict(wasted_bytes=st["wb"], time_at_risk_s=st["ts"],
                      site=st["first"][1])
            f = _group_table_finding(table, mesh, st["sites"], kw)
            if f is not None:
                out.append(f)
        # family 1: matches.  Singleton classes = channel-less rows plus
        # channels that (so far) have exactly one member.
        singles: Dict[Tuple, Dict] = {}
        for key, st in self._nochan.items():
            self._fold(singles, key, st["sites"], st["wb"], st["ts"],
                       st["first"])
        for chan in sorted(self._chan):
            members = self._chan[chan]
            if len(members) == 1:
                m = members[0]
                self._fold(singles, m["table"], 1, m["wb"], m["ts"],
                           (m["gidx"], m["name"]))
        for key, table in self._gtables.items():
            st = singles.get(key)
            if not st:
                continue
            present = _table_counts(table, nd) > 0
            missing = np.flatnonzero(~present)
            if len(missing):
                out.append(_f_coverage_singleton(
                    st["sites"], missing, nd, site=st["first"][1],
                    wasted_bytes=st["wb"], time_at_risk_s=st["ts"]))
        for chan in sorted(self._chan):
            members = self._chan[chan]
            if len(members) < 2:
                continue
            kw = dict(site=f"channel {chan}",
                      wasted_bytes=sum(m["wb"] for m in members),
                      time_at_risk_s=sum(m["ts"] for m in members))
            tables = {}
            for m in members:
                tables.setdefault(m["table"], self._gtables[m["table"]])
            out += _class_findings(
                chan,
                [(m["kind"], m["bytes"], m["dtype"], m["mult"], m["table"])
                 for m in members],
                tables, mesh, kw)
        # permute pair tables, in union table order
        for key, pairs in self._ptables.items():
            st = self._pstat.get(key)
            if not st:
                continue
            kw = dict(wasted_bytes=st["wb"], time_at_risk_s=st["ts"],
                      site=st["first"][1])
            out += _permute_table_findings(pairs, nd, st["sites"], kw)
        return rank_findings(_advise(out))
