"""The sharded train step and `Trainer --mesh` on 8 real `gloo` ranks (a
(2, 4) ("data", "model") mesh on the CPU), against the unsharded step and the
reference's.

Each test starts its ranks in subprocesses (`tests/_torch_dist_worker.py`,
or the train CLI under RANK/WORLD_SIZE), so the test process keeps no
process group.  Limits are those of `tests/test_torch_trainer.py` at fp32:
loss and grad_norm rtol 2e-5, moments per leaf 2e-5 of the leaf's largest,
params within 2 * lr (an element with a near-zero gradient can move by any
amount in [-lr, lr] in one AdamW step) and all but 1e-4 of them within 1e-6.
A checkpoint saved on 2x4 restores exactly onto 4x2, 8x1 and 1x8.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import free_port
from _torch_parity import batch_pair, model_pair
from repro.launch import presets as jpresets
from repro.launch.steps import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_train_step
from repro_torch.models.meta import leaves, tree_map
from repro_torch.optim import adamw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x22b", "qwen2-vl-2b"])
def test_sharded_step_matches_unsharded_and_reference(arch, tmp_path):
    """One `make_train_step(accum=2, remat="full")` step on 8 gloo ranks from
    the reference's seed-0 fp32 weights: loss, grad_norm, moments and params
    against the port's unsharded step and the reference's jitted one (and each
    rank's `shard_batch` rows, checked in the worker)."""
    _check_sharded_step(arch, StepSettings(accum=2, remat="full"), tmp_path)


def test_sequence_sharded_step_matches_unsharded_and_reference(tmp_path):
    """The same with `seq_shard=True`: the residual stream's sequence dim is
    also sharded over `model` (Megatron-SP), which moves only where the sums
    run, so the limits stay the fp32 ones."""
    _check_sharded_step("chatglm3-6b", StepSettings(accum=2, remat="full", seq_shard=True),
                        tmp_path)


def test_sharded_inloop_step_matches_unsharded_and_reference(tmp_path):
    """hymba-1.5b with `ssm_inloop`: the in-loop scan per rank under
    `local_map` (delta, x and A split on di over `model`, the batch over
    `data`; A's gradient partial over `data`, B's and C's over `model`),
    within the fp32 limits of the steps above."""
    _check_sharded_step("hymba-1.5b", StepSettings(accum=2, remat="full"), tmp_path,
                        ssm_inloop=True)


def _check_sharded_step(arch, st, tmp_path, **change):
    cfg, jcfg, jp, _ = model_pair(arch, "float32", **change)
    params = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu", dtype=torch.float32)
    batch, jbatch = batch_pair(cfg, 8, 32)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    oc, joc = adamw.AdamWConfig(**ocfg), jadamw.AdamWConfig(**ocfg)
    torch.save({"cfg": cfg, "opt_cfg": oc, "settings": st, "params": params,
                "batch": {k: v.numpy() for k, v in batch.items()}}, tmp_path / "inputs.pt")
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                          "step", str(tmp_path), "2", "4", str(free_port())],
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    sharded = torch.load(tmp_path / "sharded.pt", weights_only=False)

    p = tree_map(lambda t: t.clone(), params)
    p, opt, m = make_train_step(cfg, oc, st)(p, adamw.init(oc, p), batch)
    jp_new, jopt, jm = jax.jit(jax_train_step(jcfg, joc, jpresets.StepSettings(
        accum=st.accum, remat=st.remat)))(jp, jadamw.init(joc, jp), jbatch)

    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(sharded["metrics"][key], float(m[key]), rtol=F32_TOL)
        np.testing.assert_allclose(sharded["metrics"][key], float(jm[key]), rtol=F32_TOL)
    for name in ("m", "v"):
        for a, b in zip(leaves(sharded[name]), leaves(opt[name])):
            assert _rel(a, b) < F32_TOL
        for a, c in zip(jax.tree.leaves(params_to_jax(sharded[name])),
                        jax.tree.leaves(jopt[name])):
            assert _rel(a, c) < F32_TOL
    lr = float(jm["lr"])
    for ref in (jax.tree.leaves(params_to_jax(p)), jax.tree.leaves(jp_new)):
        diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
            jax.tree.leaves(params_to_jax(sharded["params"])), ref)])
        assert diff.max() <= 2 * lr, diff.max()
        assert (diff > 1e-6).mean() < 1e-4, (diff > 1e-6).sum()


def _train_cli(mesh, ckpt, steps, extra=()):
    """The train CLI on 8 gloo ranks; returns rank 0's output."""
    port = str(free_port())
    procs = []
    for rank in range(8):
        env = {**_env(), "RANK": str(rank), "WORLD_SIZE": "8", "MASTER_ADDR": "localhost",
               "MASTER_PORT": port}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "chatglm3-6b",
             "--smoke", "--device", "cpu", "--mesh", mesh, "--steps", str(steps),
             "--batch", "8", "--seq", "32", "--accum", "2", "--ckpt-dir", str(ckpt),
             "--ckpt-every", "2", *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert all(not o for o, _ in outs[1:])        # only rank 0 prints
    return outs[0][0]


def _arrays(step_dir):
    return {f: np.load(os.path.join(step_dir, f)) for f in sorted(os.listdir(step_dir))
            if f.endswith(".npy")}


def test_trainer_mesh_checkpoint_restores_onto_other_meshes(tmp_path):
    """`train --mesh 2x4 --smoke --device cpu` for 2 steps writes whole tensors;
    the checkpoint restores onto 4x2, 8x1 and 1x8 exactly (a run with nothing
    left to do saves what it restored: the same bytes), and the 2x4 run's
    losses are the unsharded CLI's within 1e-3: the smoke config computes in
    bf16, where sharded products sum in another order (the fp32 one-step
    test above holds 2e-5)."""
    ckpt = tmp_path / "ck"
    first_out = _train_cli("2x4", ckpt, 2)
    assert "[train] done" in first_out
    saved = _arrays(ckpt / "step_00000002")
    assert len(saved) > 0
    for mesh in ("4x2", "8x1", "1x8"):
        out = _train_cli(mesh, ckpt, 2)
        assert "resumed from checkpoint at step 2" in out
        again = _arrays(ckpt / "step_00000002")
        assert again.keys() == saved.keys()
        for f in saved:
            assert np.array_equal(again[f], saved[f]), (mesh, f)
    plain = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "chatglm3-6b", "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "32", "--accum", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert plain.returncode == 0, plain.stderr[-4000:]
    got, want = _losses(first_out), _losses(plain.stdout)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-3)


def _losses(out):
    return [float(line.split(" loss ")[1].split()[0]) for line in out.splitlines()
            if line.startswith("[train] step")]
