#!/usr/bin/env python3
"""What is live at a dry-run cell's fake peak: each storage the step holds when
its live bytes first reach the peak, by the op and scope that made it.

    PYTHONPATH=src python scripts/torch_peak_holders.py ARCH [LAYERS] [--multi-pod]

Runs the train_4k cell of ARCH (at LAYERS layers, default 2; gemma3-4b and
hymba-1.5b take a 2-entry window pattern) as rank 0 of the production mesh on
CPU fake tensors twice: once for the peak, once inside
`core.capture.peak_holders` to take the live set when it is reached.  Prints
the peak and the largest holders.  Settings are the cell's H100 row.
"""
import argparse
import collections
import sys

from repro_torch.configs import get_config
from repro_torch.core import capture
from repro_torch.launch import dryrun, presets
from repro_torch.launch.mesh import make_mesh_spec
from repro_torch.distributed.sharding import mesh_axis_sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("layers", nargs="?", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    over = {"num_layers": args.layers}
    if len(cfg.window_pattern or ()) > 1:
        over["window_pattern"] = (cfg.window_pattern[0], 0)
    st = presets.h100_settings_for(args.arch, "train_4k",
                                   mesh_axis_sizes(make_mesh_spec(multi_pod=args.multi_pod)))

    def cell():
        return dryrun.lower_cell(args.arch, "train_4k", device="cpu", multi_pod=args.multi_pod,
                                 settings=st, cfg_overrides=over)
    r = cell()
    peak = r["trace"].per_device_memory_bytes
    with capture.peak_holders(peak) as taken:
        cell()
    print(f"{args.arch} train_4k, {args.layers} layers, {st}: fake peak "
          f"{peak / 1e9:.2f} GB, analytic model {r['mem_model_gb']} GB")
    held = collections.Counter()
    for op, scope, shape, dtype, n in taken[0] or []:
        held[op, scope, shape, dtype] += n
    for (op, scope, shape, dtype), n in held.most_common(args.top):
        print(f"{n / 1e9:8.3f} GB  {op}  scope={scope or '-'}  {shape} {dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
