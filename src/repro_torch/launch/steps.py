"""Step factories: train (forward, backward, AdamW, gradient accumulation),
eval, prefill and decode.

The reference's factories return jittable pure functions; here they return
plain callables that run eagerly.  Serving and eval run under
`torch.no_grad`; the train step takes gradients with `torch.autograd.grad`
with respect to detached views of the params, and `adamw.update` then
writes params and moments in place.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.launch.presets import StepSettings
from repro_torch.models import api as model_api
from repro_torch.models.meta import leaves, tree_map
from repro_torch.optim import adamw


def _split_micro(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    """`accum` micro-batches of B/accum rows each, in order.  The vlm's [3, B, S]
    positions split on dim 1; a leaf whose leading dim does not divide by
    `accum` goes whole into every micro-batch, as in the reference."""
    def part(name, a, i):
        if name == "positions":
            n = a.shape[1] // accum
            return a[:, i * n:(i + 1) * n]
        if a.ndim >= 1 and a.shape[0] % accum == 0 and a.shape[0] >= accum:
            n = a.shape[0] // accum
            return a[i * n:(i + 1) * n]
        return a
    return [{k: part(k, v, i) for k, v in batch.items()} for i in range(accum)]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, st: StepSettings):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics {"loss", "grad_norm", "lr"} as 0-dim tensors.  With accum > 1 the
    gradient is the sum over micro-batches of g / accum, each term cast to
    `accum_dtype` before it is added, and the loss the mean of theirs."""
    def loss_and_grads(params, micro):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = model_api.loss_fn(cfg, live, micro, attn_impl=st.attn_impl, remat=st.remat,
                                 scan_impl="plain")
        grads = torch.autograd.grad(loss, list(leaves(live)), materialize_grads=True)
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        if st.accum > 1:
            acc_dt = getattr(torch, st.accum_dtype)
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for micro in _split_micro(batch, st.accum):
                l, g = loss_and_grads(params, micro)
                for acc, gi in zip(grads, g):
                    acc.add_((gi / st.accum).to(acc_dt))
                loss = loss + l
            loss = loss / st.accum
        else:
            loss, grads = loss_and_grads(params, batch)
        if st.grad_compression == "bf16":
            grads = [g.to(torch.bfloat16).float() for g in grads]
        it = iter(grads)
        params, opt_state, metrics = adamw.update(
            opt_cfg, tree_map(lambda _: next(it), params), opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg, st: StepSettings):
    """eval_step(params, batch) -> the training loss, under `torch.no_grad` with
    `st.attn_impl` (flash runs K1) and the scan kernel."""
    @torch.no_grad()
    def eval_step(params, batch):
        return model_api.loss_fn(cfg, params, batch, attn_impl=st.attn_impl)
    return eval_step


def make_prefill_step(cfg, st: StepSettings, cache_len=None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model_api.prefill(cfg, params, batch, attn_impl=st.attn_impl,
                                 cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg):
    """The reference's factory also takes a `StepSettings` and reads none of
    it (decode attention is always naive), so the port's takes none."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos, positions=None):
        return model_api.decode_step(cfg, params, cache, tokens, pos,
                                     positions=positions)
    return decode_step
