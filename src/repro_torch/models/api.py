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
    """`positions` overrides the rope ids: [B,1], or [3,B,1] for m-rope."""
    return transformer.decode_step(cfg, params, cache, tokens, pos,
                                   positions=positions)


def n_image_patches(cfg, seq_len: int) -> int:
    """Patch count of the vlm family's stub frontend for a sequence of `seq_len`."""
    return min(1024, max(1, seq_len // 4))


def cache_specs(cfg, shape, dtype=torch.bfloat16):
    """The decode cache's `CacheSpec`s (shape, dtype) for a `ShapeSpec`: a
    stacked dict, or a per-layer list for a windowed cache whose layers have
    different windows (`transformer.cache_specs`)."""
    return transformer.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   windowed=shape.windowed_cache, dtype=dtype)


def demo_batch(cfg, batch_size: int, seq_len: int, seed: int = 0, *, device=None):
    """{"tokens": [B, S] int64} drawn with numpy from `seed`.  For the vlm
    family, S - n_image_patches tokens after {"patch_embeds": [B, P, D] fp32}
    (standard normal), and {"positions": [3, B, S]}: 0..S-1 on each axis."""
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    batch = {}
    n_tok = seq_len
    if cfg.family == "vlm":
        n_img = n_image_patches(cfg, seq_len)
        n_tok = seq_len - n_img
        patches = rng.standard_normal((batch_size, n_img, cfg.d_model), dtype=np.float32)
        batch["patch_embeds"] = torch.from_numpy(patches).to(device)
        batch["positions"] = torch.arange(seq_len, dtype=torch.int32, device=device).expand(
            3, batch_size, seq_len)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, n_tok), dtype=np.int64)
    batch["tokens"] = torch.from_numpy(tokens).to(device)
    return batch
