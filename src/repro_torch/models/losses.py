"""Loss functions (the port of the reference's `repro.models.losses`).

Cross-entropy is taken chunk by chunk over the sequence, so the fp32
log-softmax never holds a whole [B, S, V] tensor; the training loss fuses
the LM head into each chunk and recomputes the chunk's logits in backward.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


def _xent_block(logits, targets, mask):
    """logits [B,C,V] (any float), targets [B,C] int, mask [B,C] -> (nll sum, count)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = lf.gather(-1, targets[..., None].long())[..., 0]
    return ((lse - tgt) * mask).sum(), mask.sum()


def cross_entropy(logits, targets, mask=None, chunk: int = 512):
    """Mean token NLL. logits [B,S,V], targets [B,S]."""
    B, S, V = logits.shape
    mask = (torch.ones((B, S), device=logits.device) if mask is None else mask).float()
    with record_function("loss"):
        if S * V <= (1 << 23) or S % chunk:
            tot, cnt = _xent_block(logits, targets, mask)
        else:
            tot = cnt = torch.zeros((), dtype=torch.float32, device=logits.device)
            for s in range(0, S, chunk):
                t, c = _xent_block(logits[:, s:s + chunk], targets[:, s:s + chunk],
                                   mask[:, s:s + chunk])
                tot, cnt = tot + t, cnt + c
        return tot / cnt.clamp_min(1.0)


def _head_xent(table, x_c, t_c, m_c):
    with record_function("logits"):
        logits = x_c @ table.to(x_c.dtype)
    return _xent_block(logits, t_c, m_c)


def fused_lm_head_loss(cfg, embed_params, hidden, targets, mask=None, chunk: int = 512):
    """LM head + cross-entropy, chunk by chunk over the sequence, each chunk
    under `torch.utils.checkpoint`: no [B, S, V] logits exist, forward or
    backward.  The chunk is halved until it divides S."""
    B, S, _ = hidden.shape
    table = L.head_table(cfg, embed_params)
    mask = (torch.ones((B, S), device=hidden.device) if mask is None else mask).float()
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    with record_function("loss"):
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, S, chunk):
            t, c = checkpoint(_head_xent, table, hidden[:, s:s + chunk],
                              targets[:, s:s + chunk], mask[:, s:s + chunk],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        return tot / cnt.clamp_min(1.0)


def _next_token_targets(tokens):
    """Targets rolled (not sliced) by one, the last position masked out."""
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return torch.roll(tokens, -1, dims=1), mask


def _with_aux(cfg, loss, aux):
    """The MoE's load-balancing term: router_aux_coef * aux / num_layers."""
    if cfg.num_experts:
        loss = loss + cfg.router_aux_coef * aux / max(cfg.num_layers, 1)
    return loss


def fused_next_token_loss(cfg, embed_params, hidden, batch, aux):
    """Family-aware next-token loss on the final hidden states [B,S,D]; the vlm
    family's patch positions are cut off first.  Rolling keeps the chunked
    head's sequence length a power of two."""
    tokens = batch["tokens"]
    h = hidden[:, hidden.shape[1] - tokens.shape[1]:] if cfg.family == "vlm" else hidden
    targets, mask = _next_token_targets(tokens)
    return _with_aux(cfg, fused_lm_head_loss(cfg, embed_params, h, targets, mask), aux)


def lm_loss(cfg, logits, batch, aux):
    """Next-token loss (+ MoE aux) on full logits, with the vlm's text slice."""
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        n_img = logits.shape[1] - tokens.shape[1]
        loss = cross_entropy(logits[:, n_img:-1], tokens[:, 1:])
    else:
        loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return _with_aux(cfg, loss, aux)
