"""Loss functions (the port of the reference's `repro.models.losses`).

Cross-entropy is taken chunk by chunk over the sequence, so the fp32
log-softmax never holds a whole [B, S, V] tensor; the training loss fuses
the LM head into each chunk and recomputes the chunk's logits in backward.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.autoshard import constrain
from repro_torch.models import layers as L
from repro_torch.scope import scope


def _lse_and_target(lf, targets):
    """(logsumexp over the vocab, the target's logit) of fp32 logits [B,C,V]."""
    return torch.logsumexp(lf, dim=-1), lf.gather(-1, targets[..., None].long())[..., 0]


def _lse_and_target_vocab_parallel(lf, targets):
    """The same, vocab-parallel on a mesh, as GSPMD partitions it: the max and
    the sum of exponentials reduce over the vocab shards (two all-reduces over
    `model`; torch.logsumexp would gather the logits).  DTensor cannot gather
    along a sharded dim in this torch (its masked-partial result fails to
    reduce); a one-hot product picks the same value exactly.  The targets
    are split as lf's rows first: from whole targets the one-hot would be a
    whole [B, C, V] fp32 tensor on every rank, forward and in the checkpointed
    chunk's backward."""
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.exp(lf - m).sum(dim=-1, keepdim=True)))[..., 0]
    if isinstance(lf, DTensor):
        rows = [pl if pl.is_shard(0) else Replicate() for pl in lf.placements]
        if isinstance(targets, DTensor):
            targets = targets.redistribute(lf.device_mesh, rows)
        else:
            targets = distribute_tensor(targets, lf.device_mesh, rows, src_data_rank=None)
    vocab = torch.arange(lf.shape[-1], device=targets.device)
    return lse, (lf * (targets.long()[..., None] == vocab).to(lf.dtype)).sum(-1)


def _xent_block(logits, targets, mask):
    """logits [B,C,V] (any float), targets [B,C] int, mask [B,C] -> (nll sum, count)."""
    lf = logits.float()
    pick = _lse_and_target_vocab_parallel if isinstance(lf, DTensor) else _lse_and_target
    lse, tgt = pick(lf, targets)
    return ((lse - tgt) * mask).sum(), mask.sum()


def cross_entropy(logits, targets, mask=None, chunk: int = 512):
    """Mean token NLL. logits [B,S,V], targets [B,S]."""
    B, S, V = logits.shape
    mask = (torch.ones((B, S), device=logits.device) if mask is None else mask).float()
    with scope("loss"):
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
    with scope("logits"):
        logits = constrain(x_c @ table.to(x_c.dtype), ("batch", None, "model"))
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
    with scope("loss"):
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, S, chunk):
            t, c = checkpoint(_head_xent, table, hidden[:, s:s + chunk],
                              targets[:, s:s + chunk], mask[:, s:s + chunk],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        return tot / cnt.clamp_min(1.0)


def _next_token_targets(tokens):
    """Targets rolled (not sliced) by one, the last position masked out.  The
    roll is written as a concatenation, which DTensor shards in every torch
    the port runs on."""
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1), mask


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
