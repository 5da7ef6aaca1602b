"""Decoder-LM assembly for the dense, ssm and hybrid families: params,
forward, prefill, decode.

The reference runs layers under `lax.scan` over stacked parameters with the
per-layer windows as traced scan inputs.  Here layers are a Python list of
per-layer dicts and a Python loop runs them, so each window is a plain int
(which is also what lets the flash kernel take it as a launch argument).
The decode cache keeps the reference's stacked layout: {k, v: [L,B,Sc,K,Dh]}
for attention layers, {conv: [L,B,d_conv-1,Di], ssm: [L,B,Di,N]} (fp32) for
Mamba layers, both for hybrid; decode writes it in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod


def check_supported(cfg) -> None:
    """Raise for what the port has not ported yet, naming its ROADMAP slice."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP slice 2)")
    unported = [name for name, on in (
        ("sandwich norm", cfg.sandwich_norm),
        ("qk norm", cfg.qk_norm),
        (f"norm {cfg.norm!r}", cfg.norm != "rmsnorm"),
        (f"mlp act={cfg.act!r} glu={cfg.glu}", cfg.act != "silu" or not cfg.glu),
        (f"rope {cfg.rope!r}", cfg.rope not in ("standard", "partial", "none")),
        ("tied embeddings", cfg.tie_embeddings),
    ) if on]
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not ported yet "
                                  "(ROADMAP slice 2)")


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def block_meta(cfg) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"norm1": L.norm_meta(cfg), "ssm": ssm_mod.ssm_meta(cfg)}
    m = {"norm1": L.norm_meta(cfg), "attn": attn_mod.attention_meta(cfg),
         "norm2": L.norm_meta(cfg), "mlp": L.mlp_meta(cfg)}
    if cfg.family == "hybrid":
        m["ssm"] = ssm_mod.ssm_meta(cfg)
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

def _ssm(cfg, p, h, cache):
    """The layer's SSM; with a `cache` dict, also put its final state there."""
    if cache is None:
        return ssm_mod.apply_ssm(cfg, p, h)
    y, state = ssm_mod.apply_ssm(cfg, p, h, return_state=True)
    cache.update(state)
    return y


def apply_block(cfg, p, x, positions, window: int, *, attn_impl="auto",
                collect_cache=False):
    """One layer. Returns (x, cache_entry_or_None)."""
    cache = {} if collect_cache else None
    h = L.apply_norm(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        return x + _ssm(cfg, p["ssm"], h, cache), cache
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, h, positions, positions)
    with record_function("attn"):
        out = attn_mod.attend(cfg, q, k, v, causal=True, window=window,
                              impl=attn_impl)
        attn_out = out.reshape(*out.shape[:2], -1) @ p["attn"]["wo"].to(x.dtype)
    if collect_cache:
        cache.update(k=k, v=v)
    if cfg.family == "hybrid":
        # parallel attention and Mamba heads on the same normed input, mean-fused
        attn_out = 0.5 * (attn_out + _ssm(cfg, p["ssm"], h, cache))
    x = x + attn_out
    h2 = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h2)
    return x, cache


def apply_layers(cfg, layers, x, positions, *, attn_impl="auto",
                 collect_cache=False):
    """Loop over layers. Returns (x, stacked cache or None): {k, v: [L,B,S,K,Dh]}
    and/or {conv: [L,B,d_conv-1,Di], ssm: [L,B,Di,N]}, by family."""
    entries = []
    for p, window in zip(layers, cfg.layer_windows()):
        with record_function("layer"):
            x, entry = apply_block(cfg, p, x, positions, window,
                                   attn_impl=attn_impl,
                                   collect_cache=collect_cache)
        entries.append(entry)
    if not collect_cache:
        return x, None
    return x, {name: torch.stack([e[name] for e in entries]) for name in entries[0]}


def embed_inputs(cfg, params, batch):
    """Returns (x [B,S,D], positions [B,S])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return L.embed_tokens(cfg, params["embed"], tokens), positions


def forward(cfg, params, batch, *, attn_impl="auto"):
    """Full forward to logits. Returns (logits [B,S,V], aux_loss) — aux is 0
    for the ported families (only MoE has one)."""
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    x, _ = apply_layers(cfg, params["layers"], x, positions, attn_impl=attn_impl)
    x = L.apply_norm(cfg, params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.logits_head(cfg, params["embed"], x), aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, seq_len: int, *, windowed: bool,
               dtype=torch.bfloat16, device=None):
    """Decode cache of zeros, stacked over layers: {k, v: [L,B,seq_len,K,Dh]}
    in `dtype` for attention layers, {conv: [L,B,d_conv-1,Di], ssm: [L,B,Di,N]}
    in fp32 for Mamba layers (both for hybrid)."""
    check_supported(cfg)
    cache = {}
    if cfg.family != "ssm":
        if windowed and any(w > 0 for w in cfg.layer_windows()):
            raise NotImplementedError("windowed ring cache arrives with the SWA item of "
                                      "ROADMAP slice 2")
        shape = (cfg.num_layers, batch_size, seq_len, cfg.num_kv_heads, cfg.head_dim)
        cache.update({name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("k", "v")})
    if cfg.family in ("ssm", "hybrid"):
        state = ssm_mod.init_ssm_state(cfg, batch_size, device=device)
        cache.update({name: a[None].repeat(cfg.num_layers, *(1,) * a.ndim)
                      for name, a in state.items()})
    return cache


def decode_step(cfg, params, cache, tokens, pos: int, *, positions=None):
    """One decode step. tokens [B,1] -> (logits [B,1,V], cache).

    `cache` is the stacked dict; each layer's slice is updated in place (its
    keys and values at slot `pos`, its SSM state whole; the reference donates
    the cache buffer and returns a new one) and the same dict is returned.
    """
    check_supported(cfg)
    B = tokens.shape[0]
    if positions is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        with record_function("layer"):
            x = _decode_block(cfg, p, x, {name: a[li] for name, a in cache.items()},
                              pos, window, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.logits_head(cfg, params["embed"], x), cache


def _decode_ssm(cfg, p, h, entry):
    """One SSM step; writes the layer's new conv and ssm state into `entry`'s views."""
    y, state = ssm_mod.decode_ssm(cfg, p, h, entry)
    for name, a in state.items():
        entry[name].copy_(a)
    return y


def _decode_block(cfg, p, x, entry, pos, window, positions):
    """One layer's decode step; `entry` holds views of this layer's cache slices."""
    h = L.apply_norm(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        return x + _decode_ssm(cfg, p["ssm"], h, entry)
    attn_out, _, _ = attn_mod.decode_attention(cfg, p["attn"], h, entry["k"], entry["v"],
                                               pos, window=window,
                                               positions=positions)
    if cfg.family == "hybrid":
        attn_out = 0.5 * (attn_out + _decode_ssm(cfg, p["ssm"], h, entry))
    x = x + attn_out
    h2 = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h2)


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
    x, caches = apply_layers(cfg, params["layers"], x, positions,
                             attn_impl=attn_impl, collect_cache=True)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_head(cfg, params["embed"], x)
    return logits, _pad_kv(caches, cache_len)


def _pad_kv(caches, cache_len):
    """Pad k and v [L,B,S,K,Dh] along S to `cache_len`; the SSM state keeps its shape."""
    if cache_len is None:
        return caches
    return {name: F.pad(a, (0, 0, 0, 0, 0, max(0, cache_len - a.shape[2])))
            if name in ("k", "v") else a for name, a in caches.items()}
