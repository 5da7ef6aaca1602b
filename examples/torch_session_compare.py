"""Multi-run session workflow for the PyTorch port: compare one workload
across mesh layouts (the reference's `examples/session_compare.py`).

    PYTHONPATH=src python examples/torch_session_compare.py              # on the card
    PYTHONPATH=src python examples/torch_session_compare.py --device cpu
    PYTHONPATH=src python examples/torch_session_compare.py --synthetic  # no step

The paper's headline experiment shape — the same step traced under several
mesh layouts (the MPI-library / NUMA-binding analogue): a reduced dense LM's
train step captured as rank 0 of (8, 1), (4, 2) and (2, 4) ("data",
"model") DeviceMeshes under the fake process group, each capture written as
a capture dump (as each job's rank 0 would write it) to a temporary
directory, ingested (`TraceSession.from_captures`, each dump on its own
mesh) into one named session, persisted as one artifact under `--out`,
reloaded, and rendered as n-way comparison tables and a diff.
`--synthetic` writes the seeded synthetic workload's dumps instead.
"""
import argparse
import os
import tempfile

from repro_torch.core import dump
from repro_torch.core.session import IngestReport, TraceSession
from repro_torch.core.topology import MeshSpec

LAYOUTS = (("dp8", (8, 1)), ("dp4xtp2", (4, 2)), ("dp2xtp4", (2, 4)))
AXES = ("data", "model")


def captured_trace(label, shape, device):
    """One train step of the reference example's reduced LM (4 layers,
    d_model 128, 8 x 128 tokens), rank 0 of `shape` under the fake group."""
    from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
    from repro_torch.core import trace_step
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = smoke_config(ARCHS["chatglm3-6b"]).replace(
        d_model=128, d_ff=256, num_layers=4, vocab_size=512,
        num_heads=8, num_kv_heads=4, head_dim=16)
    mesh, spec = make_host_mesh(shape, AXES, backend="fake", device=device)
    B, S = 8, 128
    params = sh.init_params(cfg, 0, mesh)
    oc = adamw.AdamWConfig()
    placements = {k: sh.placements_for(s, mesh)
                  for k, s in sh.batch_pspecs(cfg, ShapeSpec("c", "train", S, B), mesh).items()}
    batch = shard_batch(SyntheticTokens(cfg, DataConfig(B, S, seed=0)).batch_at(0),
                        mesh, placements)
    step = make_train_step(cfg, oc, StepSettings(accum=1, remat="full"))
    with activation_sharding(mesh):
        return trace_step(step, (params, adamw.init(oc, params), batch), mesh, spec,
                          label=label)


def synth_capture(label, mesh):
    """The seeded synthetic workload's capture dump on `mesh` (the reference
    example's `--synthetic` traces)."""
    from repro_torch.core.synth import synthetic_capture
    return synthetic_capture(n_sites=2000, seed=0, mesh=mesh, label=label)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--synthetic", action="store_true",
                    help="the seeded synthetic workload's dumps; no step runs")
    ap.add_argument("--out", default="results", help="directory for the saved session")
    args = ap.parse_args(argv)
    if not args.synthetic:
        from repro_torch.device import resolve_device
        device = resolve_device(args.device).type

    traces, records = [], []
    with tempfile.TemporaryDirectory() as d:
        for label, shape in LAYOUTS:
            mesh = MeshSpec(shape, AXES)
            path = os.path.join(d, f"{label}.jsonl")
            if args.synthetic:
                with open(path, "w") as f:
                    f.write(synth_capture(label, mesh))
            else:
                dump.write_capture(captured_trace(label, shape, device), path, mesh=mesh)
            one = TraceSession.from_captures(label, [path], mesh)
            traces += list(one)
            records += one.ingest_report.records
            print(f"{label}: {os.path.getsize(path)} bytes of capture dump, "
                  f"{one.totals()[0]['sites']} sites ingested")
    sess = TraceSession("mesh-layout-sweep", traces)
    sess.ingest_report = IngestReport("raise", records)
    os.makedirs(args.out, exist_ok=True)
    path = sess.save(os.path.join(args.out, "torch_mesh_layout_sweep.npz"))
    sess = TraceSession.load(path)
    print(f"saved + reloaded '{sess.name}' "
          f"({os.path.getsize(path)//1024} KB): {sess.labels()}\n")
    print(sess.table())
    print()
    print(sess.table(by="semantic", metric="time"))
    print()
    print(sess.diff(sess.labels()[0], sess.labels()[-1]))


if __name__ == "__main__":
    main()
