#!/usr/bin/env python3
"""Readings for the limits of `correct`: the program's on many seeds, the
controls' (the reference in float8 in the program's place, in each of
`reference.common.PRECISIONS` below fp32) and planted faults' on a few, for
one cell, in one process on the card.

    python3 perfbench/calibrate.py --workload chatglm3-6b.prefill-long \
        --seeds 101,102,103 --control-seeds 201,202,203 --controls fp8,fp8_gemm \
        --seconds 6 [--faults half_batch --fault-seeds 301,302,303] \
        [--out chiprun_out/calibrate.jsonl]

Each seed's readings are one JSON line on standard output (and in --out).
A prefill seed runs the cell's window for --seconds and checks what a run
checks; a train seed runs the checked steps and the reference.  The benchmark's
own runs never run this."""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv):
    import argparse
    import torch
    from perfbench.harness import spec as spec_mod
    from perfbench.harness.main import device_for, driver
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cell = spec_mod.cell(spec_mod.load_spec(), a.workload)
    device = device_for(cell)
    drv = driver(cell)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(a.out, "a") if a.out else None

    def emit(**rec):
        rec.update(workload=a.workload, device=torch.cuda.get_device_name(device))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(ints(a.seeds)):
        t = time.perf_counter()
        # a prefill's later seeds skip the warm-up, which changes no output
        warm = {"warm": i == 0} if cell.traffic["kind"] == "prefill" else {}
        res = drv.run(cell, seed, a.seconds, False, device, t, **warm)
        emit(kind="program", seed=seed, readings=res["readings"],
             done=drv.counts(res["window"])[0], s=time.perf_counter() - t)
        del res
    for seed in ints(a.fault_seeds):
        for name in [f for f in a.faults.split(",") if f]:
            warm = {"warm": False} if cell.traffic["kind"] == "prefill" else {}
            res = drv.run(cell, seed, a.seconds, False, device, time.perf_counter(),
                          fault=drv.fault(cell, name), **warm)
            emit(kind="fault", fault=name, seed=seed, readings=res["readings"])
            del res
    for seed in ints(a.control_seeds):
        for prec in [p for p in a.controls.split(",") if p]:
            t = time.perf_counter()
            emit(kind="control", prec=prec, seed=seed,
                 readings=drv.control(cell, seed, device, prec), s=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
