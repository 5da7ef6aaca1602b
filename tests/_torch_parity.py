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
