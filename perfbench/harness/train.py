"""A training cell: the Trainer's step, driven from the seed.

Set-up makes the float32 master weights and every step's tokens from the
seed (rows that all differ), builds the Trainer and its AdamW state, and
runs the first `checked_steps` steps through the window's own call and feed;
they warm up every shape, and their losses, step 1's gradient (from AdamW's
first moment: m_1 = (1 - beta1) g) and each leaf's change over them are read
for the check.  The window then carries the same state on, step after step,
each step ending with its loss on the host, until `seconds` have passed.
Afterwards the program's state is freed and the reference runs the checked
steps from its own copy of the weights, on the same tokens."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import checks, faults, program, traffic, weights
from perfbench.harness.prefill import reference_module, setup_log, sync
from perfbench.harness.trace import traced
from perfbench.reference.common import flat


@dataclass
class Window:
    step_s: list = field(default_factory=list)
    traced: list = field(default_factory=list)
    tokens_per_step: int = 0
    wall: float = 0.0
    losses: list = field(default_factory=list)


def batches(cell, seed, device):
    tr = cell.traffic
    n = tr["rows"] * tr["seq"]
    pool = traffic.token_pool(tr["steps"] * n, cell.config["model"]["vocab_size"], seed, device)
    return lambda i: pool[i * n:(i + 1) * n].view(tr["rows"], tr["seq"])


def run(cell, seed, seconds, trace, device, t_start, fault=None):
    cfg = program.model_config(cell.config)
    tr = cell.traffic
    beta1 = tr["optimizer"]["beta1"]
    marks = [("start", time.perf_counter())]
    params = weights.make(program.param_specs(cfg, torch.float32), cell.config["init"],
                          seed, device)
    start = {p: t.detach().clone() for p, t in flat(params)}
    tokens = batches(cell, seed, device)
    trainer, make_state = program.trainer(cfg, tr, device)
    opt = make_state(params)
    sync(device)
    marks.append(("weights, tokens, trainer", time.perf_counter()))
    step_fn = trainer.step if fault is None else fault(trainer.step)
    prog = {"loss": []}
    k = tr["checked_steps"]
    for i in range(k):
        params, opt, metrics = step_fn(params, opt, {"tokens": tokens(i)})
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad1"] = {p: float(m.norm()) / (1 - beta1) for p, m in flat(opt["m"])}
    prog["change"] = {p: float((t.detach() - start[p]).norm()) for p, t in flat(params)}
    del start
    sync(device)
    marks.append((f"{k} checked steps", time.perf_counter()))
    setup_log(t_start, marks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    win, out = Window(tokens_per_step=tr["rows"] * tr["seq"]), {}
    span = range(tr["trace"]["start"], tr["trace"]["start"] + tr["trace"]["count"]) \
        if trace else range(0)
    t0 = time.perf_counter()
    j = 0
    while k + j < tr["steps"] and (time.perf_counter() - t0 < seconds
                                    or (trace and j < span.stop)):
        if trace and j == span.start:
            prof = traced(out)
            prof.__enter__()
        ts = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, {"tokens": tokens(k + j)})
        win.losses.append(float(metrics["loss"]))
        win.step_s.append(time.perf_counter() - ts)
        win.traced.append(j in span)
        if trace and j == span.stop - 1:
            prof.__exit__(None, None, None)
        j += 1
    win.wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    del params, opt, metrics, trainer, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, device, tokens, "fp32")
    readings = checks.training(prog, ref)
    print(f"# change_gap leaves left out: {checks.unmoved(ref)}", file=sys.stderr, flush=True)
    return dict(setup_s=setup_s, window=win, peak=peak, readings=readings, trace=out,
                program=prog, reference=ref)


def reference_readings(cell, seed, device, tokens, prec):
    """The reference's (or, in a control's precision, the control's) checked
    steps from its own float32 weights made from the seed."""
    cfg = program.model_config(cell.config)
    tr = cell.traffic
    w = weights.make(program.param_specs(cfg, torch.float32), cell.config["init"], seed, device)
    from perfbench.reference import common
    return common.train(reference_module(cell.config), cell.config["model"], w,
                        [tokens(i) for i in range(tr["checked_steps"])], tr["optimizer"],
                        tr["accum"], prec, tr["checked_steps"])


def control(cell, seed, device, prec="fp8"):
    """The control's readings against the reference's: the reference in `prec`."""
    tokens = batches(cell, seed, device)
    ref = reference_readings(cell, seed, device, tokens, "fp32")
    low = reference_readings(cell, seed, device, tokens, prec)
    return checks.training(low, ref)


def fault(cell, name):
    """The planted fault `name` (`faults.TRAIN`) as a wrapper of the step."""
    return faults.train(name, cell.config["model"]["vocab_size"])


def end_to_end(win, setup_s):
    steps = len(win.step_s)
    return {"train_tokens_per_s": steps * win.tokens_per_step / win.wall, "setup_s": setup_s}


def counts(win):
    """(attempted, failed): steps run, and those whose loss is not a number."""
    return len(win.step_s), sum(1 for x in win.losses if not x == x)


def stretches(win):
    """What the per-layer readers read of the window: the traced and the
    untraced steps' seconds."""
    return ([s for s, t in zip(win.step_s, win.traced) if t],
            [s for s, t in zip(win.step_s, win.traced) if not t])


def overhead(win):
    """The traced steps' mean time beside the untraced ones': the tracing's cost."""
    traced, untraced = stretches(win)
    mean = lambda xs: sum(xs) / max(len(xs), 1)  # noqa: E731
    return f"tracing: step s traced {mean(traced)!r}, untraced {mean(untraced)!r}"
