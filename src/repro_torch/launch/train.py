"""Fault-tolerant training driver (the port of the reference's
`repro.launch.train`), on one card or on a ("data", "model") device mesh.

  * deterministic seekable data (a restart reproduces the batches bitwise),
  * periodic atomic checkpoints and resume from LATEST,
  * crash injection (`--fail-at-step`: exit 42) for restart-continuity tests,
  * a SIGTERM handler (checkpoint, then exit 0),
  * the straggler watchdog over step times.

Params are fp32 master weights; each layer casts them to the compute dtype
at its use.  With a mesh (`mesh=(D, M)` or a DeviceMesh; `--mesh DxM`), the
master weights and AdamW moments are DTensors placed by
`sharding.param_placements`, each batch is sharded by `shard_batch`, and the
step runs inside `autoshard.activation_sharding`, as the reference's does.
One process runs per rank: `nccl` on cards, `gloo` with `--device cpu`; the
process group reads RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (as
`torchrun` sets them).  Checkpoints hold whole tensors and restore onto any
mesh shape.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \
        --steps 4 --batch 4 --seq 2048 --accum 2       # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \
        --smoke --device cpu --steps 8 --batch 2 --seq 64 --ckpt-dir /tmp/ck --ckpt-every 2
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch chatglm3-6b --smoke --device cpu --mesh 2x4 --steps 4 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import checkpoint
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch, to_device
from repro_torch.distributed import sharding
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, parse_mesh
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api as model_api
from repro_torch.optim import adamw
from repro_torch.training.watchdog import StragglerWatchdog


class Trainer:
    def __init__(self, cfg, *, steps=100, batch=8, seq=256, ckpt_dir=None,
                 ckpt_every=50, mesh=None, settings=None, opt_cfg=None,
                 seed=0, fail_at_step=None, log_every=10, keep=3, device=None):
        self.cfg = cfg
        self.steps = steps
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.fail_at_step = fail_at_step
        self.log_every = log_every
        self.keep = keep
        self.device = resolve_device(device)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            mesh, _ = make_host_mesh(tuple(mesh), ("data", "model"), backend=backend,
                                     device=self.device.type)
        self.mesh = mesh
        self.settings = settings or StepSettings(accum=1, remat="dots")
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=1e-3, warmup_steps=20, total_steps=steps,
            state_dtype=self.settings.opt_state_dtype)
        self.data = SyntheticTokens(cfg, DataConfig(batch, seq, seed=seed))
        self.batch_placements = None
        if mesh is not None:
            specs = sharding.batch_pspecs(cfg, ShapeSpec("train", "train", seq, batch), mesh)
            self.batch_placements = {k: sharding.placements_for(s, mesh)
                                     for k, s in specs.items()}
        self.watchdog = StragglerWatchdog()
        self.metrics_log = []
        self._preempted = False
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.settings)

    # ---- state ------------------------------------------------------------
    def init_state(self, seed=0):
        if self.mesh is None:
            params = model_api.init_params(self.cfg, seed, device=self.device,
                                           dtype=torch.float32)
        else:
            params = sharding.init_params(self.cfg, seed, self.mesh)
        return params, adamw.init(self.opt_cfg, params), 0

    def _log(self, msg: str) -> None:
        """Print once: on rank 0 of a mesh."""
        if self.mesh is None or dist.get_rank() == 0:
            print(msg, flush=True)

    def batch_at(self, step: int):
        host = self.data.batch_at(step)
        if self.mesh is None:
            return to_device(host, self.device)
        return shard_batch(host, self.mesh, self.batch_placements)

    def step(self, params, opt, batch):
        """One train step (inside the mesh's activation sharding, on a mesh)."""
        if self.mesh is None:
            return self.step_fn(params, opt, batch)
        with activation_sharding(self.mesh, seq_shard=self.settings.seq_shard):
            return self.step_fn(params, opt, batch)

    def restore_or_init(self, seed=0):
        params, opt, step = self.init_state(seed)
        if self.ckpt_dir and checkpoint.latest_step(self.ckpt_dir) is not None:
            restored, extra = checkpoint.restore(self.ckpt_dir, {"params": params, "opt": opt})
            step = int(extra.get("next_step", 0))
            self._log(f"[train] resumed from checkpoint at step {step}")
            return restored["params"], restored["opt"], step
        return params, opt, step

    def save_ckpt(self, params, opt, next_step):
        if not self.ckpt_dir:
            return
        checkpoint.save(self.ckpt_dir, next_step, {"params": params, "opt": opt},
                        extra={"next_step": next_step, "arch": self.cfg.name})
        checkpoint.prune_old(self.ckpt_dir, keep=self.keep)

    # ---- loop -------------------------------------------------------------
    def run(self, seed=0) -> list:
        params, opt, start = self.restore_or_init(seed)

        def on_sigterm(_sig, _frm):
            self._preempted = True
        old = signal.signal(signal.SIGTERM, on_sigterm)

        saved = None
        try:
            for step in range(start, self.steps):
                self.watchdog.start_step(step)
                params, opt, metrics = self.step(params, opt, self.batch_at(step))
                # whole values: a DTensor loss is partial over the mesh until gathered
                loss, gnorm = (float(sharding.full_tensor(metrics[k]))
                               for k in ("loss", "grad_norm"))
                st = self.watchdog.end_step()
                self.metrics_log.append({"step": step, "loss": loss, "grad_norm": gnorm,
                                         "sec": st.duration_s, "straggler": st.flagged})
                if step % self.log_every == 0 or step == self.steps - 1:
                    self._log(f"[train] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                              f"({st.duration_s * 1e3:.0f} ms)")
                next_step = step + 1
                if self.ckpt_every and next_step % self.ckpt_every == 0:
                    self.save_ckpt(params, opt, next_step)
                    saved = next_step
                if self._preempted:
                    self._log("[train] SIGTERM: checkpointing and exiting")
                    self.save_ckpt(params, opt, next_step)
                    sys.exit(0)
                if self.fail_at_step is not None and next_step == self.fail_at_step:
                    self._log(f"[train] injected failure at step {next_step}")
                    os._exit(42)   # simulate a hard node crash
            if saved != self.steps:   # the last step's state, unless just written
                self.save_ckpt(params, opt, self.steps)
        finally:
            signal.signal(signal.SIGTERM, old)
        return self.metrics_log


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) mesh, one process per rank (e.g. under torchrun)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    tr = Trainer(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 mesh=parse_mesh(args.mesh) if args.mesh else None,
                 fail_at_step=args.fail_at_step, device=args.device,
                 settings=StepSettings(accum=args.accum, remat="dots"))
    log = tr.run(args.seed)
    losses = [m["loss"] for m in log]
    if losses:
        tr._log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                f"({len(losses)} steps)")
    if tr.mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
