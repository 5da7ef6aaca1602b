"""A hybrid-head decoder (Hymba, Dong et al., arXiv:2411.13676), as the port
runs it.  Per layer, on x [B, S, D]:

  h    = RMSNorm(x)
  q, k, v = h Wq, h Wk, h Wv in heads (GQA), RoPE on the whole of each head
            (its two halves rotated as pairs, theta 10000)
  attn = softmax(q k^T / sqrt(Dh) + mask) v, the mask keeping key j for query
         i where j <= i, and i - j < w in a layer whose window w is not 0
  ssm  = the Mamba-1 block on the same h (`reference/ssm.py` `block`: in_proj,
         causal conv, SiLU, x_proj, softplus time step, the selective scan,
         D skip, gate by SiLU(z), out_proj)
  x    = x + 0.5 * (attn Wo + ssm)
  x    = x + SwiGLU(RMSNorm(x))

then the final RMSNorm and an untied LM head.  The windows are the
configuration's `window_pattern` (hymba-1.5b: 1024, but 0 in layers 0, 15
and 31).  The cache per layer is the attention's k and v [B, S, K, Dh] and
the SSM's convolution inputs and final state.  Attention runs in blocks of
query rows, each reading only the keys its window can reach.

Departures from the paper, which the port shares (so `correct` cannot see
them): no 128 learned meta tokens before the prompt; no KV cache shared by
consecutive local layers (every layer keeps its own); the branches are
mean-fused after their own output projections, where the paper normalises
each branch's output, scales it by a learned vector and projects both
through one shared output projection; the LM head is not tied to the
embedding."""
from __future__ import annotations

import torch

from perfbench.reference import dense, ssm
from perfbench.reference.common import act, exact_fp32, mm, rms_norm, silu

Q_BLOCK = 1024           # query rows a block of the attention's scores holds


def windows(m):
    """Each layer's window (0: global)."""
    return list(m.get("window_pattern") or [m.get("window", 0)] * m["num_layers"])


def attention(m, q, k, v, window):
    """Causal softmax attention masked to i - j < window (window 0: causal
    alone), q [B,S,H,Dh] and k/v [B,S,K,Dh]; each block of query rows reads
    keys from the first its window keeps to its last row."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh)
    out = []
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        lo = max(0, s0 - window + 1) if window else 0
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, s0:s1], k[:, lo:s1]) * dh ** -0.5
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        kj = torch.arange(lo, s1, device=q.device)[None]
        drop = (kj > qi) | ((qi - kj >= window) if window else False)
        scores = scores.masked_fill(drop, float("-inf"))
        out.append(torch.einsum("bkgqs,bskd->bqkgd", scores.softmax(-1), v[:, lo:s1]))
    return torch.cat(out, dim=1).reshape(B, S, H * dh)


def layer(m, p, x, window, prec):
    """One layer on x [B, S, D]; returns (x, k, v, conv cache, SSM state)."""
    B, S, _ = x.shape
    H, K, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rms_norm(x, p["norm1"]["scale"])
    a = p["attn"]
    q = dense.rope(m, mm(h, a["wq"], prec).view(B, S, H, dh))
    k = dense.rope(m, mm(h, a["wk"], prec).view(B, S, K, dh))
    v = mm(h, a["wv"], prec).view(B, S, K, dh)
    attn = mm(attention(m, q, k, v, window), a["wo"], prec)
    out, conv, state = ssm.block(m, p["ssm"], h, prec)
    x = act(x + 0.5 * (attn + out), prec)
    h = rms_norm(x, p["norm2"]["scale"])
    f = p["mlp"]
    x = act(x + mm(silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_up"], prec), f["w_down"], prec),
            prec)
    return x, k, v, conv, state


@torch.no_grad()
def prefill(m, w, tokens, prec="fp32"):
    """(logits of the last position [B, V], {"k", "v": [per layer [B,S,K,Dh]],
    "conv": [per layer [B,d_conv-1,Di]], "ssm": [per layer [B,Di,N]]})."""
    with exact_fp32():
        x = act(w["embed"]["in_table"].float()[tokens], prec)
        cache = {"k": [], "v": [], "conv": [], "ssm": []}
        for p, window in zip(w["layers"], windows(m)):
            x, *parts = layer(m, p, x, window, prec)
            for name, t in zip(cache, parts):
                cache[name].append(t)
        x = rms_norm(x[:, -1], w["final_norm"]["scale"])
        return mm(x, w["embed"]["out_head"], prec), cache
