"""End-to-end training with the PyTorch port: train a small LM with
checkpointing, crash recovery and the straggler watchdog (the reference's
`examples/train_lm.py`).

    PYTHONPATH=src python examples/torch_train_lm.py                # ~20M params, on the card
    PYTHONPATH=src python examples/torch_train_lm.py --full         # ~100M params
    PYTHONPATH=src python examples/torch_train_lm.py --steps 50 --device cpu

Resume after interruption is automatic (same --ckpt-dir). The default
--ckpt-dir lies under the temporary directory (TMPDIR) and names the config,
so the small and the --full config never resume from each other.
"""
import argparse
import os
import tempfile

from repro_torch.configs import ARCHS
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.train import Trainer
from repro_torch.models import api
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_lm_{small,full} under TMPDIR")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_train_lm_{'full' if args.full else 'small'}")

    base = ARCHS["h2o-danube-3-4b"]
    if args.full:   # ~100M-param llama-style config
        cfg = base.replace(num_layers=12, d_model=768, num_heads=12,
                           num_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab_size=32000, window=0, window_pattern=())
    else:           # ~20M params
        cfg = base.replace(num_layers=6, d_model=384, num_heads=6,
                           num_kv_heads=2, head_dim=64, d_ff=1024,
                           vocab_size=8192, window=0, window_pattern=())

    print(f"training {cfg.name}-derived LM: {api.param_count(cfg)/1e6:.1f}M "
          f"params, {args.steps} steps, batch {args.batch} x seq {args.seq}")
    print(f"checkpoints in {ckpt_dir}")
    tr = Trainer(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=ckpt_dir, ckpt_every=50, device=args.device,
                 settings=StepSettings(accum=1, remat="dots"),
                 opt_cfg=adamw.AdamWConfig(lr=6e-4, warmup_steps=30,
                                           total_steps=args.steps))
    log = tr.run()
    losses = [m["loss"] for m in log]
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}; "
              f"stragglers flagged: {sum(m['straggler'] for m in log)}")


if __name__ == "__main__":
    main()
