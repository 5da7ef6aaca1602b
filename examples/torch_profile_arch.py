"""Profile any architecture x shape on a (2, 4) mesh with the PyTorch port and
write the interactive HTML report (the paper's visualizer artifact).

    PYTHONPATH=src python examples/torch_profile_arch.py --arch mixtral-8x22b \
        --shape decode_32k --out results/trace.html [--device cpu]

The port's counterpart of the reference's `examples/profile_arch.py`: the
cell runs at full width and depth as rank 0 of a (2, 4) ("data", "model")
DeviceMesh under torch's fake process group, on fake tensors
(`launch.dryrun.lower_cell`), so nothing is allocated; the production
256-card traces come from `python -m repro_torch.launch.dryrun --html DIR`.
"""
import argparse
import os
import tempfile

from repro_torch.core.report import semantic_table, summary, to_html, top_contenders_table
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--out", default=None,
                    help="default: repro_torch_{arch}_{shape}.html under TMPDIR")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   f"repro_torch_{args.arch}_{args.shape}.html")

    mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device=dev.type)
    print(f"tracing {args.arch} x {args.shape} on a 2x4 mesh ({dev.type}, fake tensors) ...")
    r = lower_cell(args.arch, args.shape, mesh=mesh, mesh_spec=spec, device=dev.type)
    if "skipped" in r:
        print("cell skipped:", r["skipped"])
        return
    tr = r["trace"]
    print(summary(tr))
    print(top_contenders_table(tr))
    print(semantic_table(tr))
    with open(out, "w") as f:
        f.write(to_html(tr, spec))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
