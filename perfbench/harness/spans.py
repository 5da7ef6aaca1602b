"""The port's step log (`repro_torch.scope.steps`) aligned with the window:
beside `program.py`, the one module of the benchmark that imports the port.

The port records each prefill or train step it runs, with its host time by
span.  A prefill window's requests are the last `len(window.lengths)`
prefill records, a train window's steps the last `len(window.step_s)` train
records: each record's rows and length must be its request's or step's, and
it must have been profiled exactly when the window traced it.  A mismatch
raises, as a launch count that differs does in `k1_roofline`.  Where the port
keeps no step log (a program without the recorder), the readers find nothing
to read."""
from __future__ import annotations

from repro_torch import scope as port_scope


def records(ctx):
    """The window's step records in order, as (record, traced), or None where
    the port keeps no step log."""
    log = getattr(port_scope, "steps", None)
    if log is None:
        return None
    win, kind = ctx.window, ctx.traffic["kind"]
    if kind == "prefill":
        shapes = list(zip(win.rows, win.lengths))
    elif kind == "train":
        shapes = [(ctx.traffic["rows"], ctx.traffic["seq"])] * len(win.step_s)
    else:
        raise ValueError(f"traffic kind {kind!r} has no step records")
    recs = [r for r in log if r.kind == kind]
    recs = recs[len(recs) - len(shapes):] if shapes else []
    if len(recs) != len(shapes):
        raise RuntimeError(f"{len(recs)} {kind} step records, the window has {len(shapes)}")
    for i, (r, (rows, length), traced) in enumerate(zip(recs, shapes, win.traced)):
        if (r.rows, r.length) != (rows, length) or r.profiled != traced:
            raise RuntimeError(
                f"{kind} {i} of the window: rows {rows}, length {length}, traced {traced}; "
                f"its step record {r.id}: rows {r.rows}, length {r.length}, "
                f"profiled {r.profiled}")
    return list(zip(recs, win.traced))


def untraced(ctx):
    """The step records of the window's untraced requests or steps, or None
    where there are none to read."""
    recs = records(ctx)
    if recs is None:
        return None
    out = [r for r, traced in recs if not traced]
    return out or None


def inclusive_ms(rec, name):
    """The record's inclusive milliseconds in spans of `name` (0 where none ran)."""
    return rec.spans.get(name, (0, 0, 0))[1] / 1e6


def mean_inclusive_ms(ctx, name):
    """The mean over the untraced requests or steps of `name`'s inclusive ms."""
    recs = untraced(ctx)
    if recs is None:
        return None
    return sum(inclusive_ms(r, name) for r in recs) / len(recs)
