"""Decoder-LM assembly, dense family: params, forward, prefill, decode.

The reference runs layers under `lax.scan` over stacked parameters with the
per-layer windows as traced scan inputs.  Here layers are a Python list of
per-layer dicts and a Python loop runs them, so each window is a plain int
(which is also what lets the flash kernel take it as a launch argument).
The decode cache keeps the reference's stacked layout {k, v: [L,B,Sc,K,Dh]};
decode writes it in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L


def check_supported(cfg) -> None:
    """Raise for what this slice has not ported yet, naming its ROADMAP slice."""
    if cfg.family != "dense":
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
    return {"norm1": L.norm_meta(cfg), "attn": attn_mod.attention_meta(cfg),
            "norm2": L.norm_meta(cfg), "mlp": L.mlp_meta(cfg)}


def model_meta(cfg) -> Dict[str, Any]:
    """{embed, layers: [one block dict per layer], final_norm}."""
    check_supported(cfg)
    return {"embed": L.embed_meta(cfg),
            "layers": [block_meta(cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.norm_meta(cfg)}


# --------------------------------------------------------------------------
# full forward (prefill)
# --------------------------------------------------------------------------

def apply_block(cfg, p, x, positions, window: int, *, attn_impl="auto",
                collect_cache=False):
    """One layer. Returns (x, cache_entry_or_None)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, h, positions, positions)
    with record_function("attn"):
        out = attn_mod.attend(cfg, q, k, v, causal=True, window=window,
                              impl=attn_impl)
        x = x + out.reshape(*out.shape[:2], -1) @ p["attn"]["wo"].to(x.dtype)
    h2 = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h2)
    return x, ({"k": k, "v": v} if collect_cache else None)


def apply_layers(cfg, layers, x, positions, *, attn_impl="auto",
                 collect_cache=False):
    """Loop over layers. Returns (x, stacked cache {k, v: [L,B,S,K,Dh]} or None)."""
    entries = []
    for p, window in zip(layers, cfg.layer_windows()):
        with record_function("layer"):
            x, entry = apply_block(cfg, p, x, positions, window,
                                   attn_impl=attn_impl,
                                   collect_cache=collect_cache)
        entries.append(entry)
    if not collect_cache:
        return x, None
    return x, {name: torch.stack([e[name] for e in entries]) for name in ("k", "v")}


def embed_inputs(cfg, params, batch):
    """Returns (x [B,S,D], positions [B,S])."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return L.embed_tokens(cfg, params["embed"], tokens), positions


def forward(cfg, params, batch, *, attn_impl="auto"):
    """Full forward to logits. Returns (logits [B,S,V], aux_loss) — aux is 0
    for the dense family."""
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
    """Decode cache {k, v: [L,B,seq_len,K,Dh]} of zeros."""
    if windowed and any(w > 0 for w in cfg.layer_windows()):
        raise NotImplementedError("windowed ring cache arrives with the SWA item of "
                                  "ROADMAP slice 2")
    shape = (cfg.num_layers, batch_size, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name in ("k", "v")}


def decode_step(cfg, params, cache, tokens, pos: int, *, positions=None):
    """One decode step. tokens [B,1] -> (logits [B,1,V], cache).

    `cache` is the stacked dict; each layer's slice is updated in place at
    slot `pos` (the reference donates the cache buffer and returns a new one)
    and the same dict is returned.
    """
    check_supported(cfg)
    B = tokens.shape[0]
    if positions is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    for li, (p, window) in enumerate(zip(params["layers"], cfg.layer_windows())):
        with record_function("layer"):
            x = _decode_block(cfg, p, x, cache["k"][li], cache["v"][li], pos,
                              window, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.logits_head(cfg, params["embed"], x), cache


def _decode_block(cfg, p, x, cache_k, cache_v, pos, window, positions):
    h = L.apply_norm(cfg, p["norm1"], x)
    attn_out, _, _ = attn_mod.decode_attention(cfg, p["attn"], h, cache_k, cache_v,
                                               pos, window=window,
                                               positions=positions)
    x = x + attn_out
    h2 = L.apply_norm(cfg, p["norm2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h2)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def prefill(cfg, params, batch, *, attn_impl="auto", cache_len=None):
    """Process a prompt; return (logits_last [B,1,V], stacked cache).

    `cache_len` reserves headroom for decode steps: the KV cache is padded
    with zeros past the prompt; decode masks by position.
    """
    check_supported(cfg)
    x, positions = embed_inputs(cfg, params, batch)
    x, caches = apply_layers(cfg, params["layers"], x, positions,
                             attn_impl=attn_impl, collect_cache=True)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.logits_head(cfg, params["embed"], x)
    return logits, _pad_kv(caches, cache_len)


def _pad_kv(caches, cache_len):
    if cache_len is None:
        return caches
    return {name: F.pad(a, (0, 0, 0, 0, 0, max(0, cache_len - a.shape[2])))
            for name, a in caches.items()}
