"""The port's train and eval steps, checkpoints and `Trainer` against the
reference.

The analogues of `tests/test_archs.py::test_smoke_train_step` (one
`make_train_step(accum=2, remat="dots")` step for each family
representative, here held against the reference's jitted one), of
`tests/test_checkpoint.py` without `test_elastic_restore_across_meshes`
(which waits for the sharding slice), and of `tests/test_train.py`'s
`Trainer` tests, on smoke configs on the CPU.

Tolerances of one train step at fp32 compute: loss and grad_norm rtol 2e-5,
the moments per leaf 2e-5 of the leaf's largest (the parity tests' fp32
limit), or one bf16 step (2^-7) of it where the gradient was rounded to bf16
(`grad_compression`, a bf16 accumulator): gradients 1e-6 apart can round to
neighbouring bf16 values (a reading of 4.1e-4).  The params after AdamW's
first step: a step is lr * m/(sqrt(v)+eps)
~ lr * sign(g), so an element whose gradient is near 0 may move by anything
in [-lr, lr] in one package and differently in the other.  So every element
is held within 2 * lr of the reference's, and all but 1e-4 of them within
1e-6 (readings: at most 9 of ~1e5-2e5 elements past 1e-6, the largest 2.2e-5
with lr = 5e-4).  The resume after a checkpoint is bitwise, as in the
reference's test.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from _torch_parity import batch_pair, model_pair
from repro.launch import presets as jpresets
from repro.launch.steps import _split_micro as jax_split_micro
from repro.launch.steps import make_eval_step as jax_eval_step
from repro.launch.steps import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch import checkpoint
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import presets
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import _split_micro, make_eval_step, make_train_step
from repro_torch.launch.train import Trainer
from repro_torch.optim import adamw
from repro_torch.training.watchdog import StragglerWatchdog

FAMILY_REPS = ["chatglm3-6b", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b",
               "whisper-tiny", "qwen2-vl-2b"]
F32_TOL = 2e-5
BF16_STEP = 2.0 ** -7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = smoke_config(ARCHS["h2o-danube-3-4b"])


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return np.abs(np.asarray(a, np.float32) - b).max() / (np.abs(b).max() + 1e-12)


def _one_step(arch, st, jst, B=4, S=32):
    """One train step of each package from the reference's seed-0 weights at fp32."""
    cfg, jcfg, jp, _ = model_pair(arch, "float32")
    p = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu", dtype=torch.float32)
    batch, jbatch = batch_pair(cfg, B, S)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    oc, joc = adamw.AdamWConfig(**ocfg), jadamw.AdamWConfig(**ocfg)
    out = make_train_step(cfg, oc, st)(p, adamw.init(oc, p), batch)
    ref = jax.jit(jax_train_step(jcfg, joc, jst))(jp, jadamw.init(joc, jp), jbatch)
    return jp, out, ref


def _assert_step_matches(jp, out, ref, moment_tol=F32_TOL):
    (p, opt, m), (jp_new, jopt, jm) = out, ref
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=F32_TOL)
    assert float(m["grad_norm"]) > 0 and np.isfinite(float(m["loss"]))
    assert int(opt["count"]) == int(jopt["count"]) == 1
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(params_to_jax(opt[name])), jax.tree.leaves(jopt[name])):
            assert _rel(a, b) < moment_tol
    lr = float(jm["lr"])
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree.leaves(params_to_jax(p)), jax.tree.leaves(jp_new))])
    assert diff.max() <= 2 * lr, diff.max()
    assert (diff > 1e-6).mean() < 1e-4, (diff > 1e-6).sum()
    moved = sum(float(np.abs(np.asarray(a) - np.asarray(b)).sum())
                for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_jax(p))))
    assert moved > 0


# --------------------------------------------------------------------------
# train and eval steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_REPS)
def test_train_step_matches_reference(arch):
    """One make_train_step(accum=2, remat="dots") step against the reference's
    jitted one: loss, grad_norm, lr, count, moments and params."""
    jp, out, ref = _one_step(arch, StepSettings(accum=2, remat="dots"),
                             jpresets.StepSettings(accum=2, remat="dots"))
    _assert_step_matches(jp, out, ref)


@pytest.mark.parametrize("change", [dict(grad_compression="bf16", accum=1, remat="full"),
                                    dict(accum_dtype="bfloat16", accum=2, remat="none")])
def test_train_step_options_match_reference(change):
    """grad_compression="bf16" (a bf16 round trip of the gradient) and a bf16
    gradient accumulator, each against the reference's step with the same settings."""
    jp, out, ref = _one_step("chatglm3-6b", StepSettings(**change),
                             jpresets.StepSettings(**change))
    _assert_step_matches(jp, out, ref, moment_tol=BF16_STEP)


def test_split_micro_matches_reference():
    """Micro-batch i holds rows i*B/accum.. of every leaf; the vlm's [3,B,S]
    positions split on dim 1; a leaf whose leading dim does not divide stays whole."""
    cfg, _, _, _ = model_pair("qwen2-vl-2b", "float32")
    batch, jbatch = batch_pair(cfg, 4, 32)
    batch["odd"], jbatch["odd"] = torch.arange(3), jnp.arange(3)
    micro = _split_micro(batch, 2)
    jmicro = jax_split_micro(jbatch, 2)
    for i, mb in enumerate(micro):
        for key, t in mb.items():
            ref = jmicro[key] if key == "odd" else jmicro[key][i]
            np.testing.assert_array_equal(t.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny"])
def test_eval_step_matches_reference(arch):
    """make_eval_step runs under no_grad with the kernels (here their plain
    versions); flash and naive eval against the reference's naive one."""
    cfg, jcfg, jp, p = model_pair(arch, "float32")
    batch, jbatch = batch_pair(cfg, 2, 32)
    ref = float(jax_eval_step(jcfg, jpresets.StepSettings(attn_impl="naive"))(jp, jbatch))
    for impl in ("naive", "flash"):
        loss = make_eval_step(cfg, StepSettings(attn_impl=impl))(p, batch)
        assert not loss.requires_grad
        np.testing.assert_allclose(float(loss), ref, rtol=F32_TOL)


def test_settings_for_is_the_reference_table():
    fields = ("accum", "remat", "attn_impl", "opt_state_dtype", "accum_dtype",
              "grad_compression")
    for arch in ARCHS:
        for shape in ("train_4k", "prefill_32k"):
            a, b = presets.settings_for(arch, shape), jpresets.settings_for(arch, shape)
            assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


# --------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py)
# --------------------------------------------------------------------------

def tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": torch.from_numpy(r.standard_normal((4, 8)).astype(np.float32)),
            "b": {"w": torch.from_numpy(r.standard_normal((3,)).astype(np.float32)).to(
                      torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32),
                  "layers": [torch.full((2,), float(seed)), torch.tensor(1.5).to(torch.bfloat16)]}}


def _leaves(t):
    from repro_torch.models.meta import leaves
    return list(leaves(t))


def _assert_equal_trees(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = tree()
    checkpoint.save(str(tmp_path), 5, t, extra={"next_step": 5})
    restored, extra = checkpoint.restore(str(tmp_path), t)
    assert extra["next_step"] == 5
    _assert_equal_trees(t, restored)


def test_latest_pointer_and_prune(tmp_path):
    t = tree()
    for step in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), step, t)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    checkpoint.prune_old(str(tmp_path), keep=2)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert names == ["step_00000003", "step_00000004"]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_crash_mid_write_never_corrupts(tmp_path):
    """A leftover .tmp dir (a crashed write) is invisible to restore."""
    t = tree()
    checkpoint.save(str(tmp_path), 1, t, extra={"next_step": 1})
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "arr_00000.npy", "w") as f:
        f.write("garbage")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    _, extra = checkpoint.restore(str(tmp_path), t)
    assert extra["next_step"] == 1


def test_shape_mismatch_rejected(tmp_path):
    t = tree()
    checkpoint.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpoint.restore(str(tmp_path), dict(t, a=torch.zeros(4, 9)))


@given(seed=st.integers(0, 1000))
@settings(max_examples=8, deadline=None)
def test_roundtrip_property(tmp_path_factory, seed):
    d = tmp_path_factory.mktemp(f"ck{seed}")
    t = tree(seed)
    checkpoint.save(str(d), 0, t)
    restored, _ = checkpoint.restore(str(d), t)
    _assert_equal_trees(t, restored)


def test_async_checkpointer(tmp_path):
    """Async saves snapshot the tensors at once (later in-place writes do not
    reach the file); wait() surfaces results, pruning keeps 2."""
    t = tree()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, t, extra={"next_step": step})
    saved_a = t["a"].clone()
    t["a"].add_(1.0)                 # after the snapshot
    ck.wait()
    assert checkpoint.latest_step(str(tmp_path)) == 3
    restored, extra = checkpoint.restore(str(tmp_path), t)
    assert extra["next_step"] == 3
    assert torch.equal(restored["a"], saved_a)
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(names) == 2


# --------------------------------------------------------------------------
# Trainer (tests/test_train.py)
# --------------------------------------------------------------------------

def make_trainer(tmp, **kw):
    kw.setdefault("steps", 8)
    kw.setdefault("batch", 2)
    kw.setdefault("seq", 64)
    kw.setdefault("ckpt_every", 4)
    return Trainer(CFG, ckpt_dir=str(tmp), device="cpu", **kw)


def test_loss_decreases(tmp_path):
    log = make_trainer(tmp_path, steps=15, ckpt_every=0).run()
    first = np.mean([m["loss"] for m in log[:3]])
    last = np.mean([m["loss"] for m in log[-3:]])
    assert last < first - 0.05, (first, last)


def test_resume_bitwise(tmp_path):
    """6 straight steps == 4 steps + restore + 2 steps (same data, params)."""
    log_a = make_trainer(tmp_path / "a", steps=6, ckpt_every=10).run()
    make_trainer(tmp_path / "b", steps=4, ckpt_every=4).run()
    log_b = make_trainer(tmp_path / "b", steps=6, ckpt_every=4).run()
    assert len(log_b) == 2
    assert [m["loss"] for m in log_a[-2:]] == [m["loss"] for m in log_b]
    assert [m["grad_norm"] for m in log_a[-2:]] == [m["grad_norm"] for m in log_b]
    like = make_trainer(tmp_path / "c").init_state()
    a, _ = checkpoint.restore(str(tmp_path / "a"), {"params": like[0], "opt": like[1]})
    b, _ = checkpoint.restore(str(tmp_path / "b"), {"params": like[0], "opt": like[1]})
    _assert_equal_trees(a, b)
    assert int(a["opt"]["count"]) == 6
    assert all(t.dtype == torch.float32 for t in _leaves(a["params"]))   # fp32 master weights


def test_crash_injection_and_recovery(tmp_path):
    """Hard crash at step 4 (exit 42) through the port's CLI; the restart
    resumes from the step-4 checkpoint and completes the run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "h2o-danube-3-4b",
            "--smoke", "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    res1 = subprocess.run(args + ["--fail-at-step", "4"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert res1.returncode == 42, res1.stderr[-2000:]
    assert "injected failure" in res1.stdout
    res2 = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300)
    assert res2.returncode == 0, res2.stderr[-2000:]
    assert "resumed from checkpoint at step 4" in res2.stdout
    assert "done" in res2.stdout


def test_grad_compression_still_trains():
    tr = Trainer(CFG, steps=6, batch=2, seq=64, ckpt_dir=None, ckpt_every=0, device="cpu",
                 settings=StepSettings(accum=1, remat="dots", grad_compression="bf16"))
    assert np.isfinite([m["loss"] for m in tr.run()]).all()


def test_mesh_waits_for_the_sharding_slice(monkeypatch):
    """`Trainer(mesh=...)` runs since the sharding slice (tests/test_torch_dist.py
    trains on 8 gloo ranks), and so does the MoE sort dispatch
    (tests/test_torch_moe_ep.py): a config with `moe_dispatch="sort"` runs the
    einsum dispatch without a mesh, and under a mesh takes
    `distributed.moe_ep.apply_moe_sort` when `model` divides the experts and
    the einsum dispatch otherwise, as the reference's rule does."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import moe_ep
    from repro_torch.models import api, moe
    mcfg = smoke_config(get_config("mixtral-8x22b")).replace(
        moe_dispatch="sort", compute_dtype="float32")
    layer = api.init_params(mcfg, 0, dtype=torch.float32, device="cpu")["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, mcfg.d_model)).astype(np.float32))
    y, _ = moe.apply_moe(mcfg, layer, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    calls = []
    monkeypatch.setattr(moe_ep, "apply_moe_sort", lambda c, p, xx, mesh: calls.append(mesh) or
                        (xx, torch.zeros(())))
    monkeypatch.setattr(moe, "current_mesh", lambda: "a mesh")
    for model, n in ((mcfg.num_experts, 1), (mcfg.num_experts - 1, 1)):
        monkeypatch.setattr(moe, "current_axes", lambda m=model: {"data": 2, "model": m})
        moe.apply_moe(mcfg, layer, x)
        assert len(calls) == n and calls[-1] == "a mesh"


def test_watchdog_flags_stragglers():
    wd = StragglerWatchdog(window=50, sigma=4.0)
    for i in range(30):
        wd.observe(i, 0.100 + 0.001 * (i % 3))
    assert wd.observe(31, 0.5).flagged          # 5x slower
    assert not wd.observe(32, 0.101).flagged
    assert wd.hang_deadline_s() >= 0.5


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG)
    assert Trainer(CFG, device="cpu").device.type == "cpu"
