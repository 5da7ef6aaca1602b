"""Model facade: init / forward / loss / prefill / decode entry points.

Every function takes the `ModelConfig` first; family dispatch happens here
(the encoder-decoder in `encdec`, every other family in `transformer`), so
the launch code never branches on family itself.  Entry points that create
tensors run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.autoshard import local_shape_and_offset
from repro_torch.models import encdec, transformer
from repro_torch.models import meta as meta_mod
from repro_torch.models.meta import tree_map
from repro_torch.models.losses import fused_next_token_loss


def _family(cfg):
    return encdec if cfg.family == "encdec" else transformer


def model_meta(cfg):
    return _family(cfg).model_meta(cfg)


def init_params(cfg, seed: int = 0, *, device=None, dtype=None, place=None):
    """Random params from `seed`, stored in `dtype` (default: the compute dtype;
    leaves the reference reads in fp32 stay fp32, see `ParamMeta.dtype`).

    The reference keeps fp32 params and casts them to the compute dtype at
    each use; casting once here gives the same bits at every use.  Training
    passes `dtype=torch.float32` for fp32 master weights, which every layer
    casts at its use as the reference does.  `place` maps each leaf as it is
    made (`meta.materialize`; `sharding.init_params` shards it).
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    return meta_mod.materialize(model_meta(cfg), seed, resolve_device(device), dtype, place)


def abstract_params(cfg, dtype=None):
    """The params tree as `CacheSpec`s (shape, dtype): what `init_params(cfg,
    dtype=dtype)` would make, with no tensor made."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return meta_mod.tree_map_meta(
        lambda _path, m: transformer.CacheSpec(tuple(m.shape), meta_mod.leaf_dtype(m, dtype)),
        model_meta(cfg))


def param_count(cfg) -> int:
    return meta_mod.param_count(model_meta(cfg))


def active_param_count(cfg) -> int:
    """Active params per token (MoE: top_k of num_experts experts)."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    expert_p = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts * cfg.num_layers
    return total - expert_p + expert_p * cfg.top_k // cfg.num_experts


def flops_param_count(cfg) -> int:
    """N for MODEL_FLOPS = 6·N·tokens: active matmul params per token, as the
    reference counts them (no embedding gather or learned position table; the
    LM head's D x V matmul whether tied or not)."""
    n = active_param_count(cfg) - cfg.vocab_size * cfg.d_model
    if cfg.rope == "learned":
        n -= (cfg.source_len + cfg.max_positions) * cfg.d_model
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    return n


def forward(cfg, params, batch, *, attn_impl="auto"):
    return _family(cfg).forward(cfg, params, batch, attn_impl=attn_impl)


def loss_fn(cfg, params, batch, *, attn_impl="auto", remat="none"):
    """Training loss: the LM head fused with the cross-entropy on the final hidden
    states, chunk by chunk (no [B,S,V] logits).  Under autograd an SSM
    layer's scan is K2's training entry point on the card and the plain scan
    on the CPU (`ssm.apply_ssm`)."""
    hidden, aux = _family(cfg).forward_hidden(cfg, params, batch, attn_impl=attn_impl,
                                              remat=remat)
    return fused_next_token_loss(cfg, params["embed"], hidden, batch, aux)


def prefill(cfg, params, batch, *, attn_impl="auto", cache_len=None):
    return _family(cfg).prefill(cfg, params, batch, attn_impl=attn_impl,
                                cache_len=cache_len)


def decode_step(cfg, params, cache, tokens, pos: int, *, positions=None):
    """`positions` overrides the rope ids: [B,1], or [3,B,1] for m-rope (the
    encoder-decoder's learned positions take none, as in the reference)."""
    if cfg.family == "encdec":
        return encdec.decode_step(cfg, params, cache, tokens, pos)
    return transformer.decode_step(cfg, params, cache, tokens, pos,
                                   positions=positions)


def n_image_patches(cfg, seq_len: int) -> int:
    """Patch count of the vlm family's stub frontend for a sequence of `seq_len`."""
    return min(1024, max(1, seq_len // 4))


def batch_specs(cfg, shape):
    """The train/prefill batch's layout for a `ShapeSpec`, as `CacheSpec`s
    (shape, dtype), keyed as `demo_batch` and the data pipeline key it."""
    B, S = shape.global_batch, shape.seq_len
    spec, i32, f32 = transformer.CacheSpec, torch.int32, torch.float32
    if cfg.family == "encdec":
        return {"frame_embeds": spec((B, cfg.source_len, cfg.d_model), f32),
                "tokens": spec((B, S), i32)}
    if cfg.family == "vlm":
        n_img = n_image_patches(cfg, S)
        return {"patch_embeds": spec((B, n_img, cfg.d_model), f32),
                "tokens": spec((B, S - n_img), i32),
                "positions": spec((3, B, S), i32)}
    return {"tokens": spec((B, S), i32)}


def cache_specs(cfg, shape, dtype=torch.bfloat16):
    """The decode cache's `CacheSpec`s (shape, dtype) for a `ShapeSpec`: a
    stacked dict, or a per-layer list for a windowed cache whose layers have
    different windows (`transformer.cache_specs`) and for the encoder-decoder
    (`encdec.cache_specs`)."""
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, shape.global_batch, shape.seq_len, dtype=dtype)
    return transformer.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   windowed=shape.windowed_cache, dtype=dtype)


def decode_input_specs(cfg, shape):
    """A decode step's inputs for a `ShapeSpec`, as the reference's: the cache,
    tokens [B, 1] int32, pos () int32, and for the vlm family positions
    [3, B, 1] int32 (the port's `decode_step` takes pos as a Python int)."""
    B, spec, i32 = shape.global_batch, transformer.CacheSpec, torch.int32
    specs = {"cache": cache_specs(cfg, shape), "tokens": spec((B, 1), i32),
             "pos": spec((), i32)}
    if cfg.family == "vlm":
        specs["positions"] = spec((3, B, 1), i32)
    return specs


def input_specs(cfg, shape):
    """Every input of the (cfg, shape) cell's step but the params."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape)}
    return decode_input_specs(cfg, shape)


def empty_dtensors(specs, mesh, placements):
    """A tree of `CacheSpec`s as DTensors on `mesh` with the matching tree of
    placements, each rank's shard allocated with `torch.empty` and not
    written: no numbers are drawn.  Under `FakeTensorMode` nothing is
    allocated (the dry-run's params, moments, batches and caches)."""
    from torch.distributed.tensor import DTensor

    def one(spec, pl):
        pl = tuple(pl)
        local, _ = local_shape_and_offset(spec.shape, mesh, pl)
        t = torch.empty(local, dtype=spec.dtype, device=mesh.device_type)
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(spec.shape),
                                  stride=torch.empty(spec.shape, device="meta").stride())
    return tree_map(one, specs, placements)


def demo_batch(cfg, batch_size: int, seq_len: int, seed: int = 0, *, device=None):
    """{"tokens": [B, S] int64} drawn with numpy from `seed`.  For the vlm
    family, S - n_image_patches tokens after {"patch_embeds": [B, P, D] fp32}
    (standard normal), and {"positions": [3, B, S]}: 0..S-1 on each axis.  For
    the encoder-decoder, {"frame_embeds": [B, source_len, D] fp32} (standard
    normal) before the tokens."""
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    batch = {}
    n_tok = seq_len
    if cfg.family == "encdec":
        frames = rng.standard_normal((batch_size, cfg.source_len, cfg.d_model), dtype=np.float32)
        batch["frame_embeds"] = torch.from_numpy(frames).to(device)
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
