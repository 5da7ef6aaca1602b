"""Model facade: init / forward / prefill / decode entry points.

Every function takes the `ModelConfig` first.  Entry points that create
tensors run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import meta as meta_mod
from repro_torch.models import transformer


def init_params(cfg, seed: int = 0, *, device=None, dtype=None):
    """Random params from `seed`, stored in `dtype` (default: the compute dtype;
    leaves the reference reads in fp32 stay fp32, see `ParamMeta.dtype`).

    The reference keeps fp32 params and casts them to the compute dtype at
    each use; casting once here gives the same bits at every use.
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    return meta_mod.materialize(transformer.model_meta(cfg), seed, resolve_device(device), dtype)


def param_count(cfg) -> int:
    return meta_mod.param_count(transformer.model_meta(cfg))


def forward(cfg, params, batch, *, attn_impl="auto"):
    return transformer.forward(cfg, params, batch, attn_impl=attn_impl)


def prefill(cfg, params, batch, *, attn_impl="auto", cache_len=None):
    return transformer.prefill(cfg, params, batch, attn_impl=attn_impl,
                               cache_len=cache_len)


def decode_step(cfg, params, cache, tokens, pos: int, *, positions=None):
    return transformer.decode_step(cfg, params, cache, tokens, pos,
                                   positions=positions)


def demo_batch(cfg, batch_size: int, seq_len: int, seed: int = 0, *, device=None):
    """{"tokens": [B, S] int64} drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len), dtype=np.int64)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device))}
