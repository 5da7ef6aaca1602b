"""Decoder-LM assembly for the dense, moe, ssm, hybrid and vlm families:
params, forward, prefill, decode.

The reference runs layers under `lax.scan` over stacked parameters with the
per-layer windows as traced scan inputs.  Here layers are a Python list of
per-layer dicts and a Python loop runs them, so each window is a plain int
(which is also what lets the flash kernel take it as a launch argument).
The decode cache keeps the reference's layouts: a stacked dict {k, v:
[L,B,Sc,K,Dh]} for attention layers, {conv: [L,B,d_conv-1,Di], ssm:
[L,B,Di,N]} (fp32) for Mamba layers, both for hybrid; or, for a windowed
cache whose layers have different windows (gemma3, hymba), a list of one
such dict per layer without the L axis.  A layer whose cache is exactly its
window long is a ring buffer.  Decode writes the cache in place.

Training runs `forward_hidden` with a remat policy per layer (`remat_fn`)
and `scan_impl="plain"`: neither kernel has a backward, and each kernel's
wrapper raises inside autograd.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.autoshard import constrain_residual
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.scope import scope, span

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")   # encdec: models/encdec.py


def check_supported(cfg) -> None:
    """Raise for a family this module does not assemble.  Every option of the
    families it does is ported (`ssm_inloop`: `ssm.scan_inloop`)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")


# --------------------------------------------------------------------------
# remat: the reference's jax.checkpoint policies, per layer
# --------------------------------------------------------------------------

_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """"dots": keep the outputs of matmuls without a batch dimension (`x @ w` runs
    as aten.mm), recompute everything else, as the reference's
    `dots_with_no_batch_dims_saveable` does (attention's batched products too)."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_fn(fn, remat: str):
    """fn, or fn run under `torch.utils.checkpoint`: "full" saves only its inputs,
    "dots" also the outputs of its unbatched matmuls."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_matmuls))
    raise ValueError(f"remat {remat!r} not in none|dots|full")


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def block_meta(cfg) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"norm1": L.norm_meta(cfg), "ssm": ssm_mod.ssm_meta(cfg)}
    m = {"norm1": L.norm_meta(cfg), "attn": attn_mod.attention_meta(cfg),
         "norm2": L.norm_meta(cfg)}
    if cfg.family == "moe":
        m["moe"] = moe_mod.moe_meta(cfg)
    else:
        m["mlp"] = L.mlp_meta(cfg)
    if cfg.family == "hybrid":
        m["ssm"] = ssm_mod.ssm_meta(cfg)
    if cfg.sandwich_norm:
        m["post_norm1"] = L.norm_meta(cfg)
        m["post_norm2"] = L.norm_meta(cfg)
    return m


def model_meta(cfg) -> Dict[str, Any]:
    """{embed, layers: [one block dict per layer], final_norm}."""
    check_supported(cfg)
    return {"embed": L.embed_meta(cfg),
            "layers": [block_meta(cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.norm_meta(cfg)}


# --------------------------------------------------------------------------
# full forward (prefill)
# --------------------------------------------------------------------------

def _ssm(cfg, p, h, cache, scan_impl):
    """The layer's SSM; with a `cache` dict, also put its final state there."""
    if cache is None:
        return ssm_mod.apply_ssm(cfg, p, h, scan_impl=scan_impl)
    y, state = ssm_mod.apply_ssm(cfg, p, h, return_state=True, scan_impl=scan_impl)
    cache.update(state)
    return y


def apply_block(cfg, p, x, positions, window: int, *, attn_impl="auto",
                scan_impl="kernel", collect_cache=False):
    """One layer. Returns (x, aux, cache_entry_or_None); aux is the MoE's
    load-balancing loss, None for the other families."""
    cache = {} if collect_cache else None
    h = L.apply_norm(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        return x + _ssm(cfg, p["ssm"], h, cache, scan_impl), None, cache
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, h, positions, positions)
    with scope("attn"):
        out = attn_mod.attend(cfg, q, k, v, causal=True, window=window,
                              impl=attn_impl)
        # the row-parallel partial sum reduced here, as in `layers.apply_mlp`
        attn_out = constrain_residual(attn_mod.merge_heads(out) @ p["attn"]["wo"].to(x.dtype))
    if collect_cache:
        cache.update(k=k, v=v)
    if cfg.family == "hybrid":
        # parallel attention and Mamba heads on the same normed input, mean-fused
        attn_out = 0.5 * (attn_out + _ssm(cfg, p["ssm"], h, cache, scan_impl))
    x = _residual(cfg, p, "post_norm1", x, attn_out)
    ff, aux = _ffn(cfg, p, L.apply_norm(cfg, p["norm2"], x))
    return _residual(cfg, p, "post_norm2", x, ff), aux, cache


def _residual(cfg, p, post_norm, x, y):
    """x + y; with gemma3's sandwich norm, y is normed first by `post_norm`."""
    if cfg.sandwich_norm:
        y = L.apply_norm(cfg, p[post_norm], y)
    return x + y


def _ffn(cfg, p, h):
    """The layer's feed-forward on the normed h: (MoE, its aux loss) or (MLP, None)."""
    if cfg.family == "moe":
        return moe_mod.apply_moe(cfg, p["moe"], h)
    return L.apply_mlp(cfg, p["mlp"], h), None


def _layer(cfg, p, x, *args, **kw):
    """apply_block in the `layer` scope with the residual stream constrained on
    entry and exit: the reference's layer body, which a remat recomputes whole."""
    with scope("layer"):
        x, aux, cache = apply_block(cfg, p, constrain_residual(x), *args, **kw)
        return constrain_residual(x), aux, cache


def apply_layers(cfg, layers, x, positions, *, attn_impl="auto", scan_impl="kernel",
                 remat="none", collect_cache=False):
    """Loop over layers, each under the `remat` policy. Returns (x, aux summed over
    layers, stacked cache or None): {k, v: [L,B,S,K,Dh]} and/or {conv:
    [L,B,d_conv-1,Di], ssm: [L,B,Di,N]}."""
    entries = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = remat_fn(_layer, remat)
    for p, window in zip(layers, cfg.layer_windows()):
        x, a, entry = block(cfg, p, x, positions, window, attn_impl=attn_impl,
                            scan_impl=scan_impl, collect_cache=collect_cache)
        if a is not None:
            aux = aux + a
        entries.append(entry)
    if not collect_cache:
        return x, aux, None
    with span("cache"):
        return x, aux, {name: torch.stack([e[name] for e in entries]) for name in entries[0]}


def embed_inputs(cfg, params, batch):
    """Returns (x [B,S,D], positions): [B,S], or for the vlm family the
    batch's [3,B,S] m-rope ids, with the patch embeddings in front of the
    token embeddings.  Learned positions are added to the token embeddings."""
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(getattr(torch, cfg.compute_dtype))
        tok_x = L.embed_tokens(cfg, params["embed"], tokens)
        with scope("vision_stub"):
            x = torch.cat([patches, tok_x], dim=1)
        return x, batch["positions"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return L.embed_tokens(cfg, params["embed"], tokens, positions=positions), positions


def forward_hidden(cfg, params, batch, *, attn_impl="auto", remat="none", scan_impl="kernel"):
    """Forward to the final norm's hidden states. Returns (hidden [B,S,D], aux):
    the sum of the MoE layers' load-balancing losses, 0 for the other families.
    `scan_impl`: "kernel" (K2, forward only) or "plain" (differentiable)."""
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    x, aux, _ = apply_layers(cfg, params["layers"], x, positions, attn_impl=attn_impl,
                             scan_impl=scan_impl, remat=remat)
    return _final_norm(cfg, params, x), aux


def _final_norm(cfg, params, x):
    """The final norm, its output constrained: on a mesh the head's chunks hand
    back the hidden states' gradient in DTensor's own layouts, brought to the
    residual layout (and reduced over `model`) before the norm's backward."""
    with scope("final_norm"):
        return constrain_residual(L.apply_norm(cfg, params["final_norm"], x))


def forward(cfg, params, batch, *, attn_impl="auto"):
    """Full forward to logits. Returns (logits [B,S,V], aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch, attn_impl=attn_impl)
    return L.logits_head(cfg, params["embed"], x), aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def uniform_cache(cfg, windowed: bool) -> bool:
    """True when every layer keeps one KV length: the cache is one stacked dict."""
    return cfg.family == "ssm" or not windowed or len(set(cfg.layer_windows())) == 1


def cache_specs(cfg, batch_size: int, seq_len: int, *, windowed: bool,
                dtype=torch.bfloat16):
    """The decode cache's layout as `CacheSpec`s, in the reference's structure:
    a stacked dict when `uniform_cache`, else a list of per-layer dicts.  k/v
    take `dtype` and are `seq_len` long, or min(seq_len, window) on a layer
    with a window when `windowed`; the SSM state is fp32."""
    check_supported(cfg)
    windows, f32 = cfg.layer_windows(), torch.float32
    K, Dh, Di, Ln = cfg.num_kv_heads, cfg.head_dim, cfg.d_inner, cfg.num_layers

    def entry(window, lead):
        e = {}
        if cfg.family != "ssm":
            sc = min(seq_len, window) if windowed and window > 0 else seq_len
            e["k"] = e["v"] = CacheSpec(lead + (batch_size, sc, K, Dh), dtype)
        if cfg.family in ("ssm", "hybrid"):
            e["conv"] = CacheSpec(lead + (batch_size, cfg.d_conv - 1, Di), f32)
            e["ssm"] = CacheSpec(lead + (batch_size, Di, cfg.ssm_state), f32)
        return e

    if uniform_cache(cfg, windowed):
        return entry(windows[0], (Ln,))
    return [entry(w, ()) for w in windows]


def init_cache(cfg, batch_size: int, seq_len: int, *, windowed: bool,
               dtype=torch.bfloat16, device=None):
    """Decode cache of zeros laid out by `cache_specs`."""
    def zeros(entry):
        return {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
                for name, spec in entry.items()}

    specs = cache_specs(cfg, batch_size, seq_len, windowed=windowed, dtype=dtype)
    return zeros(specs) if isinstance(specs, dict) else [zeros(e) for e in specs]


def decode_step(cfg, params, cache, tokens, pos: int, *, positions=None):
    """One decode step. tokens [B,1] -> (logits [B,1,V], cache).

    `cache` is the stacked dict or the per-layer list (`cache_specs`); each
    layer's part is updated in place (its key and value at slot `pos`, or
    `pos % window` in a ring, its SSM state whole; the reference donates the
    cache buffer and returns a new one) and the same object is returned.
    `positions` overrides the rope ids ([3,B,1] for m-rope).
    """
    check_supported(cfg)
    B = tokens.shape[0]
    if positions is None:
        positions = attn_mod.decode_positions(cfg, B, pos, tokens.device)
    windows = cfg.layer_windows()
    # learned positions are read at source_len + pos, as in the reference
    x = L.embed_tokens(cfg, params["embed"], tokens, positions=positions + cfg.source_len)
    if isinstance(cache, dict):
        entries = [{name: a[li] for name, a in cache.items()} for li in range(cfg.num_layers)]
        # a ring only when the one shared window is exactly the cache's length
        sc = cache["k"].shape[2] if "k" in cache else 0
        rings = [len(set(windows)) == 1 and windows[0] > 0 and sc == windows[0]] * len(windows)
    else:
        entries = cache
        rings = [w > 0 and "k" in e and e["k"].shape[1] == w for e, w in zip(cache, windows)]
    for p, entry, window, ring in zip(params["layers"], entries, windows, rings):
        with scope("layer"):
            x = _decode_block(cfg, p, constrain_residual(x), entry, pos, window, positions,
                              ring)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.logits_head(cfg, params["embed"], x), cache


def _decode_ssm(cfg, p, h, entry):
    """One SSM step; writes the layer's new conv and ssm state into `entry`'s views."""
    y, state = ssm_mod.decode_ssm(cfg, p, h, entry)
    for name, a in state.items():
        entry[name].copy_(a)
    return y


def _decode_block(cfg, p, x, entry, pos, window, positions, ring):
    """One layer's decode step; `entry` holds this layer's cache tensors (views
    of the stacked cache, or a per-layer list's own)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        return x + _decode_ssm(cfg, p["ssm"], h, entry)
    attn_out, _, _ = attn_mod.decode_attention(cfg, p["attn"], h, entry["k"], entry["v"],
                                               pos, window=window, windowed_cache=ring,
                                               positions=positions)
    if cfg.family == "hybrid":
        attn_out = 0.5 * (attn_out + _decode_ssm(cfg, p["ssm"], h, entry))
    x = _residual(cfg, p, "post_norm1", x, attn_out)
    ff, _ = _ffn(cfg, p, L.apply_norm(cfg, p["norm2"], x))
    return _residual(cfg, p, "post_norm2", x, ff)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def prefill(cfg, params, batch, *, attn_impl="auto", cache_len=None):
    """Process a prompt; return (logits_last [B,1,V], stacked cache).

    `cache_len` reserves headroom for decode steps: the KV cache is padded
    with zeros past the prompt; decode masks by position.  The SSM state is
    the scan's final state, taken from the prefill's own kernel launches.
    """
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    x, _, caches = apply_layers(cfg, params["layers"], x, positions,
                                attn_impl=attn_impl, collect_cache=True)
    with span("final_norm"):
        x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_head(cfg, params["embed"], x)
    return logits, _pad_kv(caches, cache_len)


def _pad_kv(caches, cache_len):
    """Pad k and v [L,B,S,K,Dh] along S to `cache_len`; the SSM state keeps its shape."""
    if cache_len is None:
        return caches
    with span("cache"):
        return {name: F.pad(a, (0, 0, 0, 0, 0, max(0, cache_len - a.shape[2])))
                if name in ("k", "v") else a for name, a in caches.items()}
