"""Static collective lint walkthrough for the PyTorch port: catch comm bugs
before any run (the reference's `examples/lint_collectives.py`).

    PYTHONPATH=src python examples/torch_lint_collectives.py              # on the card
    PYTHONPATH=src python examples/torch_lint_collectives.py --device cpu

Three passes of the `commcheck` static analyzer:

  1. clean sources: a synthetic trace, and two capture dumps this example
     writes to a temporary directory and reads back as `session ingest`
     does — a synthetic one and the capture of a smoke-size train step (rank
     0 of a (2, 4) DeviceMesh under the fake process group, on `--device`):
     zero findings each (the reference lints its committed HLO dumps here);
  2. a trace with ground-truth bugs spliced in by `synth.inject_comm_bugs`
     (every injected class must be flagged, ranked by bytes at risk);
  3. a sharding plan linted before any step runs, via `lint_pspecs`.

The same analysis drives `python -m repro_torch.core.session lint` (over
saved sessions and capture dumps) and the findings of every report.
"""
import argparse
import os
import tempfile

from repro_torch.core import commcheck, dump, synth
from repro_torch.core.topology import MeshSpec
from repro_torch.device import resolve_device

MESH = MeshSpec((2, 4), ("data", "model"))


def show(title, findings):
    print(f"\n== {title}: {len(findings)} finding(s)")
    for f in findings:
        where = f" @ {f.site}" if f.site else ""
        print(f"  [{f.severity}] {f.detector}{where}"
              f"  ({f.wasted_bytes/1e6:.2f} MB at risk)")


def captured_step(device):
    """The trace of one smoke-size train step, rank 0 of (2, 4) under the
    fake process group (the quickstart's step at smaller widths)."""
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
        d_model=128, d_ff=256, num_layers=2, vocab_size=512,
        num_heads=8, num_kv_heads=4, head_dim=16)
    mesh, spec = make_host_mesh(MESH.shape, MESH.axes, backend="fake", device=device)
    B, S = 8, 64
    params = sh.init_params(cfg, 0, mesh)
    oc = adamw.AdamWConfig()
    placements = {k: sh.placements_for(s, mesh)
                  for k, s in sh.batch_pspecs(cfg, ShapeSpec("l", "train", S, B), mesh).items()}
    batch = shard_batch(SyntheticTokens(cfg, DataConfig(B, S, seed=0)).batch_at(0),
                        mesh, placements)
    step = make_train_step(cfg, oc, StepSettings(accum=1, remat="full"))
    with activation_sharding(mesh):
        return trace_step(step, (params, adamw.init(oc, params), batch), mesh, spec,
                          label="smoke-step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. clean sources come back empty
    clean = synth.synthetic_trace("clean", MESH, n_sites=400, seed=0)
    show("clean synthetic trace", commcheck.check_trace(clean, MESH))
    with tempfile.TemporaryDirectory() as d:
        paths = {"synthetic.jsonl": os.path.join(d, "synthetic.jsonl"),
                 "smoke_step.jsonl": os.path.join(d, "smoke_step.jsonl")}
        with open(paths["synthetic.jsonl"], "w") as f:
            f.write(synth.synthetic_capture(n_sites=400, seed=1))
        dump.write_capture(captured_step(dev.type), paths["smoke_step.jsonl"], mesh=MESH)
        for name, path in paths.items():
            tr = dump.trace_from_capture(dump.read_capture(path), MESH, label=name)
            found = commcheck.check_trace(tr, MESH)
            show(f"capture dump {name} ({tr.sites} sites, "
                 f"{os.path.getsize(path)} bytes)", found)
            assert not found, name

    # 2. injected bugs: every class flagged, ground truth in `labels`
    buggy, labels = synth.inject_comm_bugs(MESH, n_sites=64, seed=0)
    findings = commcheck.check_trace(buggy, MESH)
    show("trace with injected bugs", findings)
    found = {f.detector for f in findings}
    assert set(labels.values()) <= found, (labels, found)
    print(f"   all {len(labels)} injected bug classes detected")

    # 3. sharding lint before any step (duck-typed specs: plain tuples)
    sizes = {"data": 2, "model": 4}

    class PartitionSpec(tuple):        # a spec's shape, as the rules write one
        pass
    plan = {
        "w1": PartitionSpec(("data", "model")),
        "w2": PartitionSpec(("model", "model")),      # axis used twice
        "w3": PartitionSpec(("expert", None)),        # axis not in mesh
    }
    shapes = {"w1": (128, 512), "w2": (64, 64), "w3": (32, 16)}
    show("sharding plan", commcheck.lint_pspecs(plan, sizes, shapes=shapes))


if __name__ == "__main__":
    main()
