"""The command line of one run: the cell, the device, the driver, the result."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from types import SimpleNamespace

from perfbench.harness import checks, spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level module names


class NoDevice(RuntimeError):
    """The machine lacks what the cell needs."""


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names in sys.modules that belong to JAX or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_for(cell):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no CUDA card")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {cell.chips}")
    return torch.device("cuda", 0)


def power_limit(smi):
    """What nvidia-smi, started by run.py (or the OSError it raised), said."""
    if isinstance(smi, OSError):
        return f"nvidia-smi failed: {smi}"
    try:
        return smi.communicate(timeout=60)[0].strip()
    except subprocess.TimeoutExpired:
        smi.kill()
        smi.communicate()
        return "nvidia-smi timed out"


def driver(cell):
    """The module that drives the cell's kind of traffic, `harness/<kind>.py`:
    its `run`, `end_to_end`, `counts`, `stretches`, `overhead`, `control` and
    `fault`."""
    kind = spec_mod.check_name(cell.traffic["kind"], "traffic kind")
    try:
        return importlib.import_module(f"perfbench.harness.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"perfbench.harness.{kind}":
            raise
        raise spec_mod.SpecError(f"traffic kind {kind!r}: no perfbench/harness/{kind}.py") from e


def load_reader(bench, name):
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def measure(cell, args, device, t_start, fault=None):
    """Run the cell; returns the result's dict (the last line's keys) and the checks.

    A per-layer reader reads a context: the cell's sizes and traffic, the
    traced stretch's Summary and launches, the window, and the driver's
    traced and untraced parts of it."""
    drv = driver(cell)
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start, fault=fault)
    win = res["window"]
    if args.trace:
        traced, untraced = drv.stretches(win)
        ctx = SimpleNamespace(model=cell.config["model"], traffic=cell.traffic,
                              summary=res["trace"].get("summary"),
                              launches=res["trace"].get("launches", {}), window=win,
                              traced=traced, untraced=untraced)
        print("# " + drv.overhead(win), file=sys.stderr, flush=True)
        values = {m["name"]: (load_reader(cell.bench, m["name"])(ctx), m["unit"])
                  for m in cell.per_layer}
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in values.items() if v is not None}
    else:
        # a metric `<quantity>.<part>` is the driver's quantity in the cells it lists
        e2e = drv.end_to_end(win, res["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, judged = checks.judge(res["readings"], cell.limits)
    attempted, failed = drv.counts(win)
    import torch
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    summary = res["trace"].get("summary")
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = judged
    return out, res


def main(argv, t_start, smi):
    try:
        args = parse(argv)
        spec = spec_mod.load_spec()
        cell = spec_mod.cell(spec, args.workload)
        device = device_for(cell)
    except (OSError, ValueError, KeyError, NoDevice, SystemExit) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        power_limit(smi)
        return 2
    print(f"# set-up s: harness imports and the card's check {time.perf_counter() - t_start:.2f}",
          file=sys.stderr, flush=True)
    try:
        out, _ = measure(cell, args, device, t_start)
    finally:
        smi_line = power_limit(smi)
    print(f"# device {smi_line}; seed {args.seed}; workload {args.workload}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
