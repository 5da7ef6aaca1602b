"""A Mamba-1 language model, as configured: RMSNorm, then the selective SSM
block, on a residual stream; an untied LM head.

The block (Gu and Dao, arXiv:2312.00752, Algorithm 2): in_proj to x and z
(d_inner each), a causal depthwise convolution over d_conv steps with bias,
SiLU; x_proj to the time step's low-rank input (ceil(D / 16)), B and C (N
each); delta = softplus(dt_raw @ dt_w + dt_bias); A = -exp(a_log);
h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t, y_t = <h_t, C_t> + D x_t;
out_proj of y * SiLU(z).  The decode cache is the convolution's last d_conv - 1
inputs and the final state h_S.

The recurrence runs in two levels, exact in float32: each chunk of T steps
from a zero state, all chunks at once; the chunks' end states carried across
chunks; then each step's share of its chunk's starting state added."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import act, exact_fp32, mm, next_token_loss, rms_norm, silu

CHUNK = 64


def scan(delta, x, a, b, c, chunk=CHUNK):
    """delta, x [B,S,Di]; a [Di,N]; b, c [B,S,N] -> (y [B,S,Di], h_S [B,Di,N])."""
    Bsz, S, Di = delta.shape
    pad = -S % chunk
    if pad:           # a step with delta 0 leaves the state as it is
        delta, x = F.pad(delta, (0, 0, 0, pad)), F.pad(x, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    dl = delta.reshape(Bsz, nc, chunk, Di)
    u = (delta * x).reshape(Bsz, nc, chunk, Di)
    bl, cl = b.reshape(Bsz, nc, chunk, -1), c.reshape(Bsz, nc, chunk, -1)
    h = None
    ys = []
    for t in range(chunk):
        bx = u[:, :, t, :, None] * bl[:, :, t, None, :]
        h = bx if h is None else torch.exp(dl[:, :, t, :, None] * a) * h + bx
        ys.append(torch.einsum("bcdn,bcn->bcd", h, cl[:, :, t]))
    decay = torch.exp(dl.sum(2)[..., None] * a)            # a chunk's product of a_bar
    starts, state = [], torch.zeros_like(h[:, 0])
    for i in range(nc):
        starts.append(state)
        state = decay[:, i] * state + h[:, i]
    h0 = torch.stack(starts, 1)
    cum = dl.cumsum(2)
    y = torch.stack([ys[t] + torch.einsum("bcdn,bcn->bcd", torch.exp(cum[:, :, t, :, None] * a)
                                          * h0, cl[:, :, t]) for t in range(chunk)], 2)
    return y.reshape(Bsz, nc * chunk, Di)[:, :S], state


def block(m, p, h, prec):
    """The SSM block on the normed h [B,S,D]; returns (out, conv cache, h_S)."""
    n, r, dc = m["ssm_state"], math.ceil(m["d_model"] / 16), m["d_conv"]
    x_in, z = mm(h, p["in_proj"], prec).chunk(2, dim=-1)
    S = x_in.shape[1]
    xp = F.pad(x_in, (0, 0, dc - 1, 0))
    w = p["conv_w"].float()
    conv = act(sum(xp[:, i:i + S] * w[i] for i in range(dc)) + p["conv_b"].float(), prec)
    xc = act(silu(conv), prec)
    dt_raw, b, c = mm(xc, p["x_proj"], prec).split([r, n, n], dim=-1)
    delta = F.softplus(mm(dt_raw, p["dt_w"], prec) + p["dt_bias"].float())
    y, h_last = scan(delta, xc, -torch.exp(p["a_log"].float()), b, c)
    y = y + xc * p["d_skip"].float()
    cache = F.pad(x_in[:, -(dc - 1):], (0, 0, max(0, dc - 1 - S), 0))
    return mm(y * silu(z), p["out_proj"], prec), cache, h_last


def layer(m, p, x, prec):
    out, conv, state = block(m, p["ssm"], rms_norm(x, p["norm1"]["scale"]), prec)
    return act(x + out, prec), conv, state


def hidden(m, w, tokens, prec, remat=False):
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
    """(logits of the last position [B, V], {"conv": [per layer [B,d_conv-1,Di]], "ssm": [...]})."""
    with exact_fp32():
        x = act(w["embed"]["in_table"].float()[tokens], prec)
        convs, states = [], []
        for p in w["layers"]:
            x, conv, state = layer(m, p, x, prec)
            convs.append(conv)
            states.append(state)
        x = rms_norm(x[:, -1], w["final_norm"]["scale"])
        return mm(x, w["embed"]["out_head"], prec), {"conv": convs, "ssm": states}
