"""A prefill cell: one client in a closed loop sends prompts of `rows` rows
each and waits for the first token (the argmax of the last position's
logits) on the host before it sends the next.

Set-up makes the weights and every prompt from the seed, then runs each
length the mix can draw once.  The window issues requests for `seconds`
and lets the last one finish; it keeps the outputs of the requests it will
check (`traffic.sample`, the longest and the last).  Afterwards the
program's state is freed, the reference makes its own weights from the same
seed, and each checked request's logits and cache are compared with its."""
from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import checks, faults, program, traffic, weights
from perfbench.harness.trace import traced


@dataclass
class Window:
    """What the window measured, per request: its rows and length, its time
    from issue to first token, its dispatch time (the step's call to its
    return, no sync), and whether the profiler ran."""
    rows: list = field(default_factory=list)
    lengths: list = field(default_factory=list)
    ttft: list = field(default_factory=list)
    dispatch: list = field(default_factory=list)
    traced: list = field(default_factory=list)
    wall: float = 0.0


def reference_module(config):
    import importlib
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def serving_weights(cell, seed, device):
    """The weights from the seed, in the dtype they are served in."""
    cfg = program.model_config(cell.config)
    return weights.make(program.param_specs(cfg, getattr(torch, cfg.compute_dtype)),
                        cell.config["init"], seed, device)


def prompts(cell, seed, device):
    """(lengths of every request, a function from request index to its tokens)."""
    tr = cell.traffic
    lengths = traffic.lengths(tr["lengths"], seed, tr["requests"])
    rows = tr["rows"]
    offsets = [0]
    for n in lengths:
        offsets.append(offsets[-1] + rows * n)
    pool = traffic.token_pool(offsets[-1], cell.config["model"]["vocab_size"], seed, device)
    return lengths, lambda i: pool[offsets[i]:offsets[i + 1]].view(rows, lengths[i])


def run(cell, seed, seconds, trace, device, t_start, fault=None, warm=True):
    """One run of the cell; `warm=False` (the calibration's later seeds) skips
    the warm-up, which changes no output."""
    cfg = program.model_config(cell.config)
    tr = cell.traffic
    marks = [("start", time.perf_counter())]
    params = serving_weights(cell, seed, device)
    lengths, tokens = prompts(cell, seed, device)
    sync(device)
    marks.append(("weights and prompts", time.perf_counter()))
    steps = {n: program.prefill_step(cfg, n) for n in sorted(set(
        traffic.block_lengths(tr["lengths"])))}
    if fault is not None:
        steps = {n: fault(step) for n, step in steps.items()}
    for n, step in steps.items() if warm else ():       # warm up every length once
        logits, _ = step(params, {"tokens": tokens(lengths.index(n))})
        logits[:, -1].argmax(-1).cpu()
    sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_log(t_start, marks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    win, kept, out = Window(), {}, {}
    t0 = time.perf_counter()
    i = 0
    trace_span = range(tr["trace"]["start"], tr["trace"]["start"] + tr["trace"]["count"]) \
        if trace else range(0)
    prof = None
    picked = set(traffic.sample(tr["sample"], seed, tr["sample"]["from_first"]))
    longest = (-1, None)
    while i < len(lengths) and (time.perf_counter() - t0 < seconds
                                 or (trace and i < trace_span.stop)):
        if i == trace_span.start and trace:
            program.zero_launches()
            prof = traced(out)
            prof.__enter__()
        batch = {"tokens": tokens(i)}
        t_issue = time.perf_counter()
        logits, cache = steps[lengths[i]](params, batch)
        t_ret = time.perf_counter()
        logits[:, -1].argmax(-1).cpu()
        t_done = time.perf_counter()
        win.rows.append(tr["rows"])
        win.lengths.append(lengths[i])
        win.ttft.append(t_done - t_issue)
        win.dispatch.append(t_ret - t_issue)
        win.traced.append(i in trace_span)
        entry = (i, logits, cache)
        if i in picked:
            kept[i] = entry
        if lengths[i] > longest[0]:
            longest = (lengths[i], entry)
        last = entry
        if trace and i == trace_span.stop - 1:
            prof.__exit__(None, None, None)
            out["launches"] = program.launches()
        i += 1
    win.wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    check = dict(kept)
    for extra, wanted in ((longest[1], tr["sample"]["longest"]), (last, tr["sample"]["last"])):
        if wanted:
            check[extra[0]] = extra
    del params, steps, kept, longest, last, logits, cache, entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = compare(cell, seed, device, check, tokens)
    return dict(setup_s=setup_s, window=win, peak=peak, readings=readings, checked=sorted(check),
                trace=out)


def compare(cell, seed, device, check, tokens):
    """Worst readings over the checked requests {index: (index, logits, cache)}:
    the program's outputs against the reference's in float32, which makes its
    own weights from the seed."""
    ref, m, w = reference_module(cell.config), cell.config["model"], serving_weights(cell, seed,
                                                                                    device)
    readings = []
    for j, (_, logits, cache) in sorted(check.items()):
        ref_logits, ref_cache = ref.prefill(m, w, tokens(j), "fp32")
        readings.append(checks.serving(logits[:, -1], cache, ref_logits, ref_cache))
        del ref_logits, ref_cache
    return checks.worst(readings)


def control(cell, seed, device, prec="fp8"):
    """The control's readings: the reference in `prec` put in the program's
    place, on the requests a run of this seed checks (the seeded ones among
    the first `from_first`, and the longest of those as its longest)."""
    ref, m, w = reference_module(cell.config), cell.config["model"], serving_weights(cell, seed,
                                                                                    device)
    lengths, tokens = prompts(cell, seed, device)
    spec = cell.traffic["sample"]
    n_done = spec["from_first"]
    picked = traffic.sample(spec, seed, n_done)
    picked.append(max(range(n_done), key=lambda j: (lengths[j], -j)))
    readings = []
    for j in sorted(set(picked)):
        low_logits, low_cache = ref.prefill(m, w, tokens(j), prec)
        ref_logits, ref_cache = ref.prefill(m, w, tokens(j), "fp32")
        readings.append(checks.serving(low_logits, low_cache, ref_logits, ref_cache))
        del low_cache, ref_cache
    return checks.worst(readings)


def fault(cell, name):
    """The planted fault `name` (`faults.PREFILL`) as a wrapper of the step."""
    return faults.prefill(name)


def setup_log(t_start, marks):
    """Set-up's parts on standard error: seconds before the driver, then each mark's."""
    parts = [f"before {marks[0][1] - t_start:.2f}"] + [
        f"{name} {t - marks[i][1]:.2f}" for i, (name, t) in enumerate(marks[1:])]
    print("# set-up s: " + ", ".join(parts), file=sys.stderr, flush=True)


def end_to_end(win, setup_s):
    """The cell's end-to-end numbers from an untraced window."""
    tokens = sum(r * n for r, n in zip(win.rows, win.lengths))
    return {"prefill_tokens_per_s": tokens / win.wall,
            "ttft_p95_ms": 1e3 * statistics.quantiles(win.ttft, n=20, method="inclusive")[18],
            "setup_s": setup_s}


def counts(win):
    """(attempted, failed): every request issued reached its first token."""
    return len(win.ttft), 0


def stretches(win):
    """What the per-layer readers read of the window: the traced requests as
    (rows, length), the untraced ones as (rows, length, ttft, dispatch)."""
    traced = [(r, n) for r, n, t in zip(win.rows, win.lengths, win.traced) if t]
    untraced = [(r, n, s, d) for r, n, s, d, t in
                zip(win.rows, win.lengths, win.ttft, win.dispatch, win.traced) if not t]
    return traced, untraced


def overhead(win):
    """The traced stretch's rate beside the untraced rest's: the tracing's cost."""
    def rate(traced):
        reqs = [(r * n, s) for r, n, s, t in zip(win.rows, win.lengths, win.ttft, win.traced)
                if t == traced]
        return sum(x for x, _ in reqs) / max(sum(s for _, s in reqs), 1e-9)
    return f"tracing: prefill tokens/s traced {rate(True)!r}, untraced {rate(False)!r}"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
