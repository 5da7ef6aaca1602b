"""Encoder-decoder transformer (whisper-tiny backbone): params, forward,
prefill, decode.

The port of the reference's `repro.models.encdec`.  The conv/audio frontend
is a stub: the model takes precomputed frame embeddings [B, source_len, D].
The encoder is a bidirectional transformer; each decoder layer adds
cross-attention against the encoder memory's K/V.  Positions are learned:
the encoder reads rows 0..Sm-1 of the position table, the decoder rows
source_len + pos.  Every attention here is `auto` (naive or blocked, never
the kernel), as in the reference, which ignores `attn_impl` on this family.

As in `transformer`, layers are a Python list of per-layer dicts.  The
decode cache is a list of one {k, v, cross_k, cross_v} dict per decoder
layer, each [B, S, K, Dh]; prefill pads only k and v to `cache_len`, and
decode writes k and v in place and reads the cross K/V as prefill left them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.autoshard import constrain_residual
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.scope import scope


def encoder_block_meta(cfg):
    return {"norm1": L.norm_meta(cfg), "attn": attn_mod.attention_meta(cfg),
            "norm2": L.norm_meta(cfg), "mlp": L.mlp_meta(cfg)}


def decoder_block_meta(cfg):
    return {"norm1": L.norm_meta(cfg), "attn": attn_mod.attention_meta(cfg),
            "norm2": L.norm_meta(cfg), "cross": attn_mod.attention_meta(cfg),
            "norm3": L.norm_meta(cfg), "mlp": L.mlp_meta(cfg)}


def model_meta(cfg) -> Dict[str, Any]:
    """{embed, enc_layers: [...], enc_norm, layers: [...], final_norm}."""
    return {"embed": L.embed_meta(cfg),
            "enc_layers": [encoder_block_meta(cfg) for _ in range(cfg.encoder_layers)],
            "enc_norm": L.norm_meta(cfg),
            "layers": [decoder_block_meta(cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.norm_meta(cfg)}


# --------------------------------------------------------------------------
# encoder, decoder layers
# --------------------------------------------------------------------------

def _encoder_block(cfg, p, x):
    x = constrain_residual(x)
    h = L.apply_norm(cfg, p["norm1"], x)
    x = x + attn_mod.apply_attention(cfg, p["attn"], h, None, causal=False)
    return constrain_residual(x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x)))


def encode(cfg, params, frame_embeds, *, remat="none"):
    """Encoder over stub frame embeddings [B, Sm, D] -> memory [B, Sm, D]."""
    with scope("encoder"):
        x = frame_embeds.to(getattr(torch, cfg.compute_dtype))
        x = x + params["embed"]["pos_table"][:x.shape[1]].to(x.dtype)
        block = transformer.remat_fn(_encoder_block, remat)
        for p in params["enc_layers"]:
            with scope("layer"):
                x = block(cfg, p, x)
        return L.apply_norm(cfg, params["enc_norm"], x)


def _decoder_block(cfg, p, x, memory, collect_cache):
    """One decoder layer. Returns (x, {k, v, cross_k, cross_v} or None)."""
    x = constrain_residual(x)
    h = L.apply_norm(cfg, p["norm1"], x)
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, h, None, None)
    with scope("self_attn"):
        out = attn_mod.attend(cfg, q, k, v, causal=True)
        x = x + attn_mod.merge_heads(out) @ p["attn"]["wo"].to(x.dtype)
    mem_kv = attn_mod.encode_memory_kv(cfg, p["cross"], memory)
    x = x + attn_mod.apply_cross_attention(cfg, p["cross"], L.apply_norm(cfg, p["norm2"], x),
                                           mem_kv)
    x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm3"], x))
    cache = ({"k": k, "v": v, "cross_k": mem_kv[0], "cross_v": mem_kv[1]}
             if collect_cache else None)
    return x, cache


def _decoder(cfg, params, tokens, memory, *, remat="none", collect_cache=False):
    """Embed tokens [B, S] at positions source_len + 0..S-1 and run the decoder
    layers. Returns (x [B, S, D], per-layer caches or Nones)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    x = L.embed_tokens(cfg, params["embed"], tokens, positions=positions + cfg.source_len)
    block = transformer.remat_fn(_decoder_block, remat)
    caches = []
    for p in params["layers"]:
        with scope("layer"):
            x, cache = block(cfg, p, x, memory, collect_cache)
        caches.append(cache)
    return x, caches


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------

def forward_hidden(cfg, params, batch, *, attn_impl="auto", remat="none"):
    """Teacher-forced forward to the decoder's final-norm hidden states [B,S,D].
    Returns (hidden, aux = 0).  `attn_impl` is ignored (every attention here is
    `auto`, as in the reference)."""
    memory = encode(cfg, params, batch["frame_embeds"], remat=remat)
    x, _ = _decoder(cfg, params, batch["tokens"], memory, remat=remat)
    return (transformer._final_norm(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(cfg, params, batch, *, attn_impl="auto"):
    """Full forward to logits. Returns (logits [B,S,V], aux_loss = 0)."""
    x, aux = forward_hidden(cfg, params, batch, attn_impl=attn_impl)
    return L.logits_head(cfg, params["embed"], x), aux


def prefill(cfg, params, batch, *, attn_impl="auto", cache_len=None):
    """Encode the frames and run the prompt; return (logits_last [B,1,V], cache):
    a list of one {k, v, cross_k, cross_v} per decoder layer, k and v padded
    with zeros to `cache_len` (decode masks by position)."""
    memory = encode(cfg, params, batch["frame_embeds"])
    x, caches = _decoder(cfg, params, batch["tokens"], memory, collect_cache=True)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    if cache_len is not None:
        pad = (0, 0, 0, 0, 0, max(0, cache_len - batch["tokens"].shape[1]))
        caches = [{name: F.pad(a, pad) if name in ("k", "v") else a for name, a in c.items()}
                  for c in caches]
    return L.logits_head(cfg, params["embed"], x), caches


def decode_step(cfg, params, cache, tokens, pos: int):
    """One decoder token against the self-attention cache and the cached
    cross K/V. tokens [B,1] -> (logits [B,1,V], cache); each layer's k and v are
    written in place at slot `pos`, and the same list is returned."""
    B = tokens.shape[0]
    pos_ids = torch.full((B, 1), pos + cfg.source_len, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(cfg, params["embed"], tokens, positions=pos_ids)
    for p, entry in zip(params["layers"], cache):
        with scope("layer"):
            h = L.apply_norm(cfg, p["norm1"], x)
            a, _, _ = attn_mod.decode_attention(cfg, p["attn"], h, entry["k"], entry["v"], pos)
            x = x + a
            x = x + attn_mod.apply_cross_attention(
                cfg, p["cross"], L.apply_norm(cfg, p["norm2"], x),
                (entry["cross_k"], entry["cross_v"]))
            x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm3"], x))
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.logits_head(cfg, params["embed"], x), cache


def cache_specs(cfg, batch_size: int, seq_len: int, dtype=torch.bfloat16):
    """The decode cache's layout: one {k, v: [B, seq_len, K, Dh], cross_k, cross_v:
    [B, source_len, K, Dh]} of `CacheSpec`s per decoder layer."""
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    kv = transformer.CacheSpec((batch_size, seq_len, K, Dh), dtype)
    cross = transformer.CacheSpec((batch_size, cfg.source_len, K, Dh), dtype)
    return [{"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
            for _ in range(cfg.num_layers)]
