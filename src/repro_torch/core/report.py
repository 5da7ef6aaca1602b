"""Renderers: ASCII / JSON / self-contained HTML (the Fig 3 visualizer), a
copy of the reference's `core/report.py` with its columnar engine only.

Views (paper analogues):
  * top-contenders table   — Table II: bytes% (count%) per kind x link class
  * communication matrix   — Fig 3b heatmap over mesh coordinates
  * device view            — Fig 3d: per-link-class traffic graph
  * timeline               — Fig 3a: modeled serialized collective schedule
  * semantic breakdown     — the MPI-function layer rollup

The renderers are columnar by default: everything events-proportional
(the JSON event array, the table rollups, the timeline sort) emits
straight from `TraceStore` columns — vocab entries are formatted once
and broadcast through codes, rows never materialize as
`CollectiveEvent` objects, and `write_json`/`write_html` stream the
output in bounded chunks so a 1M-site trace renders without holding
the rendered text (or the row objects) in memory.  The reference keeps
a per-event walk beside it; the port's texts are held byte-identical to
the reference's columnar ones on the same session by
tests/test_torch_backhalf.py.
"""
from __future__ import annotations

import html as html_mod
import json
from json.encoder import encode_basestring_ascii as _esc_json
from typing import IO, Iterator, List, Optional

import numpy as np

from repro_torch.core import commcheck
from repro_torch.core.diff import _norm_by, diff_n
from repro_torch.core.events import Trace
from repro_torch.core.topology import MeshSpec, comm_matrix, reduce_matrix

# comm-matrix guard: above this per-axis device count the O(n^2) cell grid
# is replaced by a top-K pair summary (the 256+-device renderer fall-over)
MATRIX_MAX_DIM = 64
MATRIX_TOP_K = 32


def trace_findings(trace: Trace):
    """Static-analysis findings for a trace, cached on the trace object.

    `to_json` and `to_html` share one commcheck pass per store: the cache
    key is the store identity, so a mutated/invalidated trace re-analyzes
    while repeat renders are free.
    """
    store = trace.store
    cached = getattr(trace, "_report_findings", None)
    if cached is not None and cached[0] is store:
        return cached[1]
    findings = commcheck.check_trace(trace)
    trace._report_findings = (store, findings)
    return findings


# --------------------------------------------------------------------------
# ASCII
# --------------------------------------------------------------------------

_CONTENDERS_HEAD = (f"{'key':44s} {'bytes%':>8s} {'count%':>8s} {'GB':>10s} "
                    f"{'count':>8s} {'est_ms':>8s}")


def _contenders_text(rows, tot_b: float, tot_c: float, tot_t: float) -> str:
    """Shared formatter: rows are (key, bytes, count, time_s) tuples."""
    tot_b = tot_b or 1.0
    tot_c = tot_c or 1.0
    lines = [_CONTENDERS_HEAD]
    for k, b, c, t in rows:
        lines.append(
            f"{k:44s} {100*b/tot_b:7.1f}% {100*c/tot_c:7.1f}% "
            f"{b/1e9:10.3f} {int(c):8d} {t*1e3:8.3f}")
    lines.append(f"{'total':44s} {'100.0%':>8s} {'100.0%':>8s} "
                 f"{tot_b/1e9:10.3f} {int(tot_c):8d} {tot_t*1e3:8.3f}")
    return "\n".join(lines)


def top_contenders_table(trace: Trace, by: str = "kind_link") -> str:
    """Bytes% (count%) per traffic class — Table II analogue.

    Rows sort by descending bytes, ties alphabetically (a total order).
    The total-ms cell accumulates in row order (`serial_est_time_s`).
    """
    by = _norm_by(by)
    s = trace.store
    labels, mat = s.rollup(by)
    if labels:
        alph = np.argsort(np.asarray(labels))
        b, c, t = mat[0][alph], mat[2][alph], mat[3][alph]
        order = np.argsort(-b, kind="stable")
        rows = [(labels[int(alph[i])], float(b[i]), float(c[i]), float(t[i]))
                for i in (int(j) for j in order)]
    else:
        rows = []
    return _contenders_text(rows, float(mat[0].sum()), float(mat[2].sum()),
                            s.serial_est_time_s())


def semantic_table(trace: Trace) -> str:
    return top_contenders_table(trace, by="semantic")


_TIMELINE_HEAD = (f"{'t_start_us':>10s} {'dur_us':>9s} {'x':>5s} {'kind':18s} "
                  f"{'link':16s} {'semantic':14s} scope")


def ascii_matrix(mat: np.ndarray, labels: Optional[List[str]] = None) -> str:
    """A square matrix as rows of shade characters, each cell scaled to the
    matrix's largest value (" " none, "@" the largest); `labels` name the
    rows (default: their indices)."""
    n = mat.shape[0]
    labels = labels or [str(i) for i in range(n)]
    peak = mat.max() or 1.0
    shades = " .:-=+*#%@"
    out = []
    for i in range(n):
        row = "".join(shades[min(int(mat[i, j] / peak * (len(shades) - 1)),
                                 len(shades) - 1)] for j in range(n))
        out.append(f"{labels[i]:>6s} |{row}|")
    return "\n".join(out)


def timeline(trace: Trace, top: int = 30) -> str:
    """Modeled serialized schedule of the heaviest collectives (Fig 3a)."""
    lines = [_TIMELINE_HEAD]
    t = 0.0
    s = trace.store
    step = s.est_time_s * s.weights
    order = np.argsort(-step, kind="stable")[:top]
    # vocab lookups + float products only for the selected rows
    rows = zip((s.est_time_s[order] * 1e6).tolist(), step[order].tolist(),
               s.multiplicity[order].tolist(),
               [s.kind.vocab[c] for c in s.kind.codes[order].tolist()],
               [s.link_class.vocab[c]
                for c in s.link_class.codes[order].tolist()],
               [s.semantic.vocab[c] for c in s.semantic.codes[order].tolist()],
               [s.scope.vocab[c][:48] for c in s.scope.codes[order].tolist()])
    for dur, dt, mult, kind, link, sem, scope in rows:
        lines.append(f"{t*1e6:10.1f} {dur:9.2f} {mult:5d} {kind:18s} "
                     f"{link:16s} {sem:14s} {scope}")
        t += dt
    return "\n".join(lines)


def summary(trace: Trace) -> str:
    n_ev = int(trace.store.multiplicity.sum())
    return (
        f"trace '{trace.label}': mesh {trace.mesh_shape} axes {trace.mesh_axes}\n"
        f"  collectives/step: {n_ev} ({trace.store.n} sites)\n"
        f"  collective bytes (operand conv): {trace.total_collective_bytes()/1e9:.3f} GB/device\n"
        f"  wire bytes: {trace.total_wire_bytes()/1e9:.3f} GB total\n"
        f"  modeled collective time: {trace.total_est_time_s()*1e3:.3f} ms (serialized)\n"
        f"  HLO flops/device: {trace.hlo_flops/1e12:.3f} T, bytes: {trace.hlo_bytes/1e9:.2f} GB\n"
        f"  per-device memory: {trace.per_device_memory_bytes/1e9:.2f} GB")


# --------------------------------------------------------------------------
# n-way session comparison (the "Allreduce across MPI libraries" table)
# --------------------------------------------------------------------------

def session_table(traces, by: str = "kind_link", metric: str = "bytes",
                  top: int = 24) -> str:
    """N-way comparison: one row per traffic class, one column per trace.

    `traces` is any sequence of Trace (a TraceSession iterates as one).
    `metric` selects the cell value: bytes (GB), time (ms), or count.
    `by="site"` keys rows on the interned op_name x kind x axes triple —
    the per-callsite view.  The paper's cross-run experiment shape (UCX
    settings / MPI libraries / NUMA bindings) as a single table —
    `diff.render_diff` stays the two-column deep-dive.
    """
    traces = list(traces)
    if not traces:
        return "(empty session)"
    rows = diff_n(traces, by)
    labels = [t.label for t in traces]
    scale, unit = {"bytes": (1e-9, "GB"), "time": (1e3, "ms"),
                   "count": (1.0, "x")}[metric]
    width = max(10, max(len(l) for l in labels) + 1)
    head = f"{'key (' + unit + ')':42s} " + \
        " ".join(f"{l[:width-1]:>{width}s}" for l in labels) + "  verdict"
    lines = [f"session comparison ({len(traces)} traces, by {by})", head]
    for r in rows[:top]:
        vals = {"bytes": r.bytes_, "time": r.times, "count": r.counts}[metric]
        cells = " ".join(f"{v*scale:{width}.3f}" for v in vals)
        lines.append(f"{r.key:42s} {cells}  {r.verdict()}")
    if len(rows) > top:
        lines.append(f"... ({len(rows) - top} more classes)")
    totals = [t.total_est_time_s() * 1e3 for t in traces]
    lines.append(f"{'TOTAL modeled collective ms':42s} " +
                 " ".join(f"{v:{width}.3f}" for v in totals) +
                 ("  best=" + labels[int(np.argmin(totals))] if totals else ""))
    return "\n".join(lines)


# --------------------------------------------------------------------------
# JSON / HTML
# --------------------------------------------------------------------------

def _embed(value, depth: int) -> str:
    """`json.dumps(value, indent=1)` re-indented for embedding at `depth`."""
    return json.dumps(value, indent=1).replace("\n", "\n" + " " * depth)


# one event object of the `indent=1` document; string args arrive
# pre-escaped (with quotes), est_time_us pre-formatted via float repr —
# the exact text `json.dumps` produces for the same values.
_EVENT_TMPL = (
    '  {\n   "name": %s,\n   "kind": %s,\n   "bytes": %d,\n   "mult": %d,\n'
    '   "link": %s,\n   "axes": %s,\n   "semantic": %s,\n   "scope": %s,\n'
    '   "prim": %s,\n   "protocol": %s,\n   "group_size": %d,\n'
    '   "num_groups": %d,\n   "est_time_us": %s\n  }')


def iter_json(trace: Trace, chunk_sites: int = 8192) -> Iterator[str]:
    """Generator over the JSON document text, `chunk_sites` events at a
    time — the streaming core of `to_json`/`write_json`.

    Emits straight from store columns: per-vocab strings are escaped once
    (axes tables pre-rendered as embedded arrays) and broadcast through
    codes; numeric columns convert chunk-wise via `.tolist()`.  Output is
    byte-identical to `json.dumps(..., indent=1)` over one dict per event,
    which pure-Python-encodes when an indent is set.
    """
    s = trace.store
    head = "{\n" + ",\n".join(
        f' "{k}": {_embed(v, 1)}' for k, v in (
            ("label", trace.label),
            ("mesh_shape", list(trace.mesh_shape)),
            ("mesh_axes", list(trace.mesh_axes)),
            ("hlo_flops", trace.hlo_flops),
            ("hlo_bytes", trace.hlo_bytes),
            ("per_device_memory_bytes", trace.per_device_memory_bytes),
            ("findings", [f.to_dict() for f in trace_findings(trace)])))
    if s.n == 0:
        yield head + ',\n "events": []\n}'
        return
    yield head + ',\n "events": ['
    kindv = [_esc_json(v) for v in s.kind.vocab]
    linkv = [_esc_json(v) for v in s.link_class.vocab]
    semv = [_esc_json(v) for v in s.semantic.vocab]
    scopev = [_esc_json(v) for v in s.scope.vocab]
    primv = [_esc_json(v) for v in s.jax_prim.vocab]
    protov = [_esc_json(v) for v in s.protocol.vocab]
    axesv = [_embed(list(t), 3) for t in s.axes_tables]
    sep = "\n"
    for lo in range(0, s.n, max(chunk_sites, 1)):
        hi = min(lo + max(chunk_sites, 1), s.n)
        rows = zip(
            s.names[lo:hi],
            s.kind.codes[lo:hi].tolist(), s.operand_bytes[lo:hi].tolist(),
            s.multiplicity[lo:hi].tolist(),
            s.link_class.codes[lo:hi].tolist(), s.axes_code[lo:hi].tolist(),
            s.semantic.codes[lo:hi].tolist(), s.scope.codes[lo:hi].tolist(),
            s.jax_prim.codes[lo:hi].tolist(),
            s.protocol.codes[lo:hi].tolist(), s.group_size[lo:hi].tolist(),
            s.num_groups[lo:hi].tolist(),
            (s.est_time_s[lo:hi] * 1e6).tolist())
        yield sep + ",\n".join(
            _EVENT_TMPL % (_esc_json(nm), kindv[kc], ob, mu, linkv[lc],
                           axesv[ac], semv[sc], scopev[scp], primv[pc],
                           protov[prc], gs, ng, repr(us))
            for (nm, kc, ob, mu, lc, ac, sc, scp, pc, prc, gs, ng, us)
            in rows)
        sep = ",\n"
    yield "\n ]\n}"


def to_json(trace: Trace) -> str:
    return "".join(iter_json(trace))


def write_json(trace: Trace, fp: IO[str], chunk_sites: int = 8192) -> None:
    """Stream the JSON report to `fp` in bounded memory."""
    for chunk in iter_json(trace, chunk_sites):
        fp.write(chunk)


_HTML_HEAD = """<!doctype html><meta charset="utf-8">
<title>repro trace: %s</title>
<style>
 body{font:13px monospace;background:#111;color:#ddd;margin:24px}
 h2{color:#7fd} table{border-collapse:collapse;margin:12px 0}
 td,th{border:1px solid #333;padding:3px 8px;text-align:right}
 th{background:#222;color:#7fd} td.l{text-align:left}
 .hm td{width:14px;height:14px;padding:0;border:1px solid #222}
 .bar{background:#167;display:inline-block;height:10px}
</style>"""


def iter_html(trace: Trace, mesh: MeshSpec) -> Iterator[str]:
    """Generator over the HTML report sections (join with newlines)."""
    yield _HTML_HEAD % html_mod.escape(trace.label)
    yield f"<h1>trace: {html_mod.escape(trace.label)}</h1>"
    yield "<pre>" + html_mod.escape(summary(trace)) + "</pre>"

    # static-analysis findings (one pass per store)
    findings = trace_findings(trace)
    yield "<h2>commcheck findings (static analysis)</h2>"
    if not findings:
        yield "<pre>no findings — collective structure checks clean</pre>"
    else:
        rows = ["<table><tr><th>severity</th><th>code</th><th>site</th>"
                "<th>MB at risk</th><th class='l'>message</th>"
                "<th class='l'>recommendation</th></tr>"]
        for f in findings[:50]:
            rows.append(
                f"<tr><td>{html_mod.escape(f.severity)}</td>"
                f"<td class='l'>{html_mod.escape(f.detector)}</td>"
                f"<td class='l'>{html_mod.escape(f.site)}</td>"
                f"<td>{f.wasted_bytes/1e6:.2f}</td>"
                f"<td class='l'>{html_mod.escape(f.message)}</td>"
                f"<td class='l'>{html_mod.escape(f.recommendation)}</td></tr>")
        if len(findings) > 50:
            rows.append(f"<tr><td colspan='6' class='l'>... "
                        f"({len(findings) - 50} more)</td></tr>")
        rows.append("</table>")
        yield "".join(rows)

    # top contenders
    yield "<h2>top contenders (kind x link) — Table II analogue</h2>"
    yield "<pre>" + html_mod.escape(
        top_contenders_table(trace)) + "</pre>"
    yield "<h2>semantic (MPI-layer analogue)</h2>"
    yield "<pre>" + html_mod.escape(
        semantic_table(trace)) + "</pre>"

    # comm matrix heatmaps per axis (mesh-sized)
    mat = comm_matrix(mesh, trace)
    for axis in mesh.axes:
        red = reduce_matrix(mat, mesh, axis)
        peak = red.max() or 1.0
        yield f"<h2>comm matrix over axis '{axis}' (GB)</h2>"
        if red.shape[0] > MATRIX_MAX_DIM:
            # big-mesh guard: n^2 <td> cells fall over past ~256 devices —
            # summarize the heaviest pairs instead of painting the grid
            flat = red.ravel()
            k = min(MATRIX_TOP_K, int((flat > 0).sum()))
            top = np.argsort(-flat, kind="stable")[:k]
            rows = [f"<p>{red.shape[0]}x{red.shape[1]} matrix "
                    f"(&gt; {MATRIX_MAX_DIM} groups) — top {k} pairs of "
                    f"{int((flat > 0).sum())} nonzero, "
                    f"{flat.sum()/1e9:.3f} GB total</p>",
                    "<table><tr><th>src</th><th>dst</th><th>GB</th>"
                    "<th class='l'>share</th></tr>"]
            for idx in top.tolist():
                i, j = divmod(idx, red.shape[1])
                bar = int(120 * flat[idx] / peak)
                rows.append(
                    f"<tr><td>{i}</td><td>{j}</td>"
                    f"<td>{flat[idx]/1e9:.3f}</td>"
                    f"<td class='l'><span class='bar' "
                    f"style='width:{bar}px'></span></td></tr>")
            rows.append("</table>")
            yield "".join(rows)
            continue
        rows = ["<table class='hm'>"]
        for i in range(red.shape[0]):
            cells = []
            for j in range(red.shape[1]):
                v = red[i, j] / peak
                col = f"rgb({int(20+v*40)},{int(30+v*160)},{int(60+v*180)})"
                cells.append(f"<td style='background:{col}' "
                             f"title='{i}->{j}: {red[i,j]/1e9:.3f} GB'></td>")
            rows.append("<tr>" + "".join(cells) + "</tr>")
        rows.append("</table>")
        yield "".join(rows)

    # timeline
    yield "<h2>modeled timeline (top collectives)</h2>"
    yield "<pre>" + html_mod.escape(timeline(trace)) + "</pre>"


def to_html(trace: Trace, mesh: MeshSpec) -> str:
    """Self-contained HTML report (the interactive-visualizer analogue)."""
    return "\n".join(iter_html(trace, mesh))


def write_html(trace: Trace, mesh: MeshSpec, fp: IO[str]) -> None:
    """Stream the HTML report to `fp` section by section."""
    for i, part in enumerate(iter_html(trace, mesh)):
        fp.write(("\n" if i else "") + part)
