"""Shared helpers for the port's parity tests: seeded inputs for both packages."""
import numpy as np
import torch

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's FLASH_CASES (tests/test_kernels.py:22) and their tolerances
FLASH_CASES = [
    # B, H, K, S, D, causal, window, dtype, tol
    (1, 2, 2, 256, 128, True, 0, "float32", 2e-5),
    (2, 4, 2, 256, 128, True, 64, "float32", 2e-5),
    (1, 2, 1, 512, 128, False, 0, "float32", 2e-5),
    (1, 6, 3, 256, 256, True, 0, "float32", 2e-5),
    (1, 4, 4, 128, 128, True, 0, "bfloat16", 3e-2),
    (1, 2, 2, 384, 128, True, 128, "bfloat16", 3e-2),
]


def randn(rng, shape, dtype: str):
    """A seeded numpy normal tensor in `dtype`, as (torch tensor, fp32 numpy copy).

    Rounding to bf16 happens once, in torch; the fp32 copy holds the same
    values exactly, so jax can cast it to bf16 without a second rounding.
    """
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(TORCH_DTYPES[dtype])
    return t, t.float().numpy()


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in fp32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def qkv(seed, B, H, K, Sq, Skv, D, dtype):
    """q [B,H,Sq,D], k/v [B,K,Skv,D], each as (torch tensor, fp32 numpy copy)."""
    rng = np.random.default_rng(seed)
    return (randn(rng, (B, H, Sq, D), dtype), randn(rng, (B, K, Skv, D), dtype),
            randn(rng, (B, K, Skv, D), dtype))


def max_abs_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


# the reference's MAMBA_CASES (tests/test_kernels.py:69): B, S, Di, N and the
# Pallas kernel's chunk and di_block (the CUDA kernel has no tiling knobs)
MAMBA_CASES = [
    (1, 128, 64, 8, 64, 64),
    (2, 256, 128, 16, 64, 64),
    (1, 512, 256, 16, 128, 128),
    (1, 96, 64, 4, 32, 64),      # non-pow2 seq
]


def scan_inputs(seed, B, S, Di, N):
    """a_bar = exp(-|z|), bx = 0.1 z, c = z as fp32 numpy arrays, made as the
    reference's kernel tests make them."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal((B, S, Di, N)))).astype(np.float32)
    bx = (rng.standard_normal((B, S, Di, N)) * 0.1).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return a, bx, c


# --------------------------------------------------------------------------
# whole models: the reference's seed-0 smoke weights in both packages
# (jax is imported inside these, so the card-only tests can import this file)
# --------------------------------------------------------------------------

def model_pair(arch, dtype, **change):
    """(port cfg, reference cfg, reference params, port params): the smoke config
    of `arch` in `dtype` with `change`, and the reference's seed-0 weights bridged."""
    import jax
    from repro.configs import ARCHS
    from repro.configs import smoke_config as jax_smoke
    from repro.models import api as jax_api
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config, smoke_config

    cfg = smoke_config(get_config(arch)).replace(compute_dtype=dtype, **change)
    jcfg = jax_smoke(ARCHS[arch]).replace(compute_dtype=dtype, **change)
    jp = jax_api.init_params(jcfg, 0)
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")


def batch_pair(cfg, B, S, seed=0):
    """One numpy-seeded batch of S positions for both packages, as (port batch,
    reference batch); a vlm batch has patch embeddings and [3, B, S] positions,
    an encoder-decoder batch frame embeddings."""
    import jax.numpy as jnp
    from repro_torch.models import api

    batch = api.demo_batch(cfg, B, S, seed, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy() if v.is_floating_point()
                             else v.numpy().astype(np.int32)) for k, v in batch.items()}
    return batch, jbatch


def n_patches(batch) -> int:
    return batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0


def prefix(batch, n):
    """The batch's first n positions (n past the patches, for a vlm batch)."""
    out = dict(batch, tokens=batch["tokens"][:, :n - n_patches(batch)])
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :, :n]
    return out


def step_at(batch, i):
    """(token [B, 1] at sequence position i, decode kwargs: the [3, B, 1]
    m-rope ids of a vlm batch)."""
    t = i - n_patches(batch)
    kw = {"positions": batch["positions"][:, :, i:i + 1]} if "positions" in batch else {}
    return batch["tokens"][:, t:t + 1], kw


def assert_cpu_training_takes_the_plain_scan(cfg, p, batch, monkeypatch, **loss_kw):
    """A loss under autograd on real CPU tensors calls neither K2 entry point
    (both made to raise) and counts no launch; its loss and gradients equal
    bit for bit those of the same loss with the mixer's scan taken explicitly
    through the plain scan: `ref.scan_inloop` under `cfg.ssm_inloop`, else
    `ref.scan_chunked` on the discretised inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops, ref
    from repro_torch.models import api, ssm
    from repro_torch.models.meta import leaves, tree_map

    def loss_and_grads():
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = api.loss_fn(cfg, live, batch, **loss_kw)
        return loss, torch.autograd.grad(loss, list(leaves(live)), allow_unused=True)

    def plain(d, x, a, b, c, *, return_state=False):
        if cfg.ssm_inloop:
            return ref.scan_inloop(d, x.float(), a, b, c, return_state=return_state)
        return ref.scan_chunked(*ref._discretise(d, x.float(), a, b), c,
                                return_state=return_state)

    def refuse(*a, **k):
        raise AssertionError("a CPU loss under autograd called a K2 entry point")
    before = fa.launches, ms.launches, dict(ms.kernel_launches)
    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan_train", refuse)
        m.setattr(ops, "mamba_scan_fused", refuse)
        loss, grads = loss_and_grads()
    assert (fa.launches, ms.launches, ms.kernel_launches) == before
    with monkeypatch.context() as m:          # the scan taken explicitly
        m.setattr(ssm, "_on_host", lambda t: False)
        m.setattr(ops, "mamba_scan_train", plain)
        loss0, grads0 = loss_and_grads()
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert (g is None and g0 is None) or torch.equal(g, g0)
