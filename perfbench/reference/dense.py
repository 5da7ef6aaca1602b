"""A dense decoder with grouped-query attention, as configured: RMSNorm before
attention and before a SwiGLU MLP, rotary positions on the first
`rope_fraction` of each head (its two halves rotated as pairs), causal
softmax attention at scale head_dim^-1/2, an untied LM head.

Weights are read by the tree's keys: embed/in_table [V, D] and out_head
[D, V]; per layer norm1/scale, attn/{wq, wk, wv, wo}, norm2/scale,
mlp/{w_gate, w_up, w_down}, each [in, out]; final_norm/scale."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import act, exact_fp32, mm, next_token_loss, rms_norm, silu

Q_BLOCK = 1024           # query rows a block of the attention's scores holds


def rope(m, x):
    """x [B, S, heads, Dh]: the first rot = Dh * rope_fraction channels turned by
    position * theta^(-i / (rot / 2)), channel i against channel i + rot / 2."""
    S, dh = x.shape[1], x.shape[-1]
    rot = int(dh * m.get("rope_fraction", 1.0))
    rot -= rot % 2
    half = rot // 2
    inv = m.get("rope_theta", 10000.0) ** (-torch.arange(half, dtype=torch.float32,
                                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def attention(m, q, k, v):
    """Causal softmax attention, q [B,S,H,Dh] and k/v [B,S,K,Dh], in blocks of query rows."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh)
    out = []
    for s0 in range(0, S, Q_BLOCK):
        qb = qg[:, s0:s0 + Q_BLOCK]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qb, k) * dh ** -0.5
        qi = torch.arange(s0, s0 + qb.shape[1], device=q.device)[:, None]
        scores = scores.masked_fill(torch.arange(S, device=q.device)[None] > qi, float("-inf"))
        out.append(torch.einsum("bkgqs,bskd->bqkgd", scores.softmax(-1), v))
    return torch.cat(out, dim=1).reshape(B, S, H * dh)


def layer(m, p, x, prec):
    """One layer on x [B, S, D]; returns (x, k, v) with k, v [B, S, K, Dh] as cached."""
    B, S, _ = x.shape
    H, K, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rms_norm(x, p["norm1"]["scale"])
    a = p["attn"]
    q = rope(m, mm(h, a["wq"], prec).view(B, S, H, dh))
    k = rope(m, mm(h, a["wk"], prec).view(B, S, K, dh))
    v = mm(h, a["wv"], prec).view(B, S, K, dh)
    x = act(x + mm(attention(m, q, k, v), a["wo"], prec), prec)
    h = rms_norm(x, p["norm2"]["scale"])
    f = p["mlp"]
    x = act(x + mm(silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_up"], prec), f["w_down"], prec),
            prec)
    return x, k, v


def hidden(m, w, tokens, prec, remat=False):
    """The final norm's output [B, S, D] for token ids [B, S]."""
    x = act(w["embed"]["in_table"].float()[tokens], prec)
    for p in w["layers"]:
        if remat:
            x = checkpoint(lambda x, p=p: layer(m, p, x, prec)[0], x, use_reentrant=False)
        else:
            x = layer(m, p, x, prec)[0]
    return rms_norm(x, w["final_norm"]["scale"])


def loss(m, w, tokens, prec):
    return next_token_loss(mm(hidden(m, w, tokens, prec, remat=True), w["embed"]["out_head"],
                              prec), tokens)


@torch.no_grad()
def prefill(m, w, tokens, prec="fp32"):
    """(logits of the last position [B, V], {"k": [per layer [B,S,K,Dh]], "v": ...})."""
    with exact_fp32():
        x = act(w["embed"]["in_table"].float()[tokens], prec)
        ks, vs = [], []
        for p in w["layers"]:
            x, k, v = layer(m, p, x, prec)
            ks.append(k)
            vs.append(v)
        x = rms_norm(x[:, -1], w["final_norm"]["scale"])
        return mm(x, w["embed"]["out_head"], prec), {"k": ks, "v": vs}
