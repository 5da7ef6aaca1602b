"""Quickstart for the PyTorch port: capture the communication of a sharded
training step, read it, and save it as a session.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs one train step of a reduced dense LM (the reference quickstart's:
`examples/quickstart.py`) as rank 0 of a (2, 4) ("data", "model") DeviceMesh
under torch's fake process group, captures its collectives
(`repro_torch.core.trace_step`), and prints the multi-layer trace:
the summary, top contenders (Table II analogue), semantic rollup (MPI-layer
analogue), modeled timeline and roofline terms on the H100 model.  The
trace is saved as a one-trace session under `--out` (default `results/`),
which `python -m repro_torch.core.session show|table|report|...` reads.
"""
import argparse
import os

from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.core import roofline, trace_step
from repro_torch.core.report import semantic_table, summary, timeline, top_contenders_table
from repro_torch.core.session import TraceSession
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="results", help="directory for the saved session")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(ARCHS["chatglm3-6b"]).replace(
        d_model=256, d_ff=512, num_layers=6, vocab_size=1024,
        num_heads=8, num_kv_heads=4, head_dim=32)
    mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device=dev.type)
    B, S = 8, 256
    params = sh.init_params(cfg, 0, mesh)
    oc = adamw.AdamWConfig()
    opt = adamw.init(oc, params)
    placements = {k: sh.placements_for(s, mesh)
                  for k, s in sh.batch_pspecs(cfg, ShapeSpec("q", "train", S, B), mesh).items()}
    batch = shard_batch(SyntheticTokens(cfg, DataConfig(B, S, seed=0)).batch_at(0),
                        mesh, placements)
    step = make_train_step(cfg, oc, StepSettings(accum=2, remat="full"))

    print(f"capturing one train step on a 2x4 mesh ({dev.type}, rank 0 under the fake "
          f"process group) ...")
    with activation_sharding(mesh):
        trace = trace_step(step, (params, opt, batch), mesh, spec, label="quickstart")
    print()
    print(summary(trace))
    print("\n--- top contenders (collective kind x link class) ---")
    print(top_contenders_table(trace))
    print("\n--- semantic rollup (grad_sync / attention / ffn / ...) ---")
    print(semantic_table(trace))
    print("\n--- modeled timeline (heaviest collectives) ---")
    print(timeline(trace, top=10))
    rf = roofline(trace, model_flops=6.0 * api.flops_param_count(cfg) * B * S)
    print(f"\nroofline: compute {rf.compute_s*1e3:.2f} ms | memory "
          f"{rf.memory_s*1e3:.2f} ms | collective {rf.collective_s*1e3:.2f} ms"
          f" -> dominant: {rf.dominant} (mfu bound {rf.model_roofline_fraction:.3f})")
    os.makedirs(args.out, exist_ok=True)
    path = TraceSession("torch-quickstart", [trace]).save(
        os.path.join(args.out, "torch_quickstart.json"))
    print(f"\nsaved session -> {path} (python -m repro_torch.core.session show {path})")


if __name__ == "__main__":
    main()
