"""Before/after workflow on the PyTorch port: diff the communication of two
configurations.

    PYTHONPATH=src python examples/torch_diff_configs.py [--device cpu]

The port's counterpart of the reference's `examples/diff_configs.py`: the
same arch x shape traced under two serving weight placements (FSDP-sharded
vs replicated over `data`) as rank 0 of a (2, 4) ("data", "model")
DeviceMesh under torch's fake process group, on fake tensors
(`launch.dryrun.lower_cell`), and the per-class traffic diff printed: the
per-layer weight all-gathers vanish under replication, traded for
per-device memory.
"""
import argparse
import dataclasses

from repro_torch.core.diff import render_diff
from repro_torch.device import resolve_device
from repro_torch.launch import presets
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device=dev.type)
    arch, shape = args.arch, args.shape

    st = presets.settings_for(arch, shape)
    base = lower_cell(arch, shape, mesh=mesh, mesh_spec=spec, device=dev.type,
                      settings=dataclasses.replace(st, serve_fsdp=True))
    opt = lower_cell(arch, shape, mesh=mesh, mesh_spec=spec, device=dev.type,
                     settings=dataclasses.replace(st, serve_fsdp=False))
    a, b = base["trace"], opt["trace"]
    a.label, b.label = "fsdp-weights", "replicated-weights"
    print(f"per-device memory (analytic): {base['mem_model_gb']} GB -> "
          f"{opt['mem_model_gb']} GB")
    print(render_diff(a, b))
    print()
    print(render_diff(a, b, by="semantic"))


if __name__ == "__main__":
    main()
