"""Step factories: train (forward, backward, AdamW, gradient accumulation),
eval, prefill and decode.

The reference's factories return jittable pure functions; here they return
plain callables that run eagerly.  Serving and eval run under
`torch.no_grad`; the train step takes gradients with `torch.autograd.grad`
with respect to detached views of the params, and `adamw.update` then
writes params and moments in place.

On a mesh (params as DTensors, the step run inside
`autoshard.activation_sharding`) the same code runs sharded: DTensor leaves
a weight's gradient partial over the axes its batch was split on, and a
hook on each param redistributes it to the param's placements, under the
`grad_sync` scope, as backward makes it: the gradient synchronisation (a
reduce-scatter for a sharded weight, an all-reduce for a replicated one), in
every micro-batch, as the reference's compiled step does it inside its scan
over micro-batches.  No gradient is then held whole over `data` to the
step's end.

Each step a factory returns opens a step record (`repro_torch.scope.step`:
`prefill_step`, `decode_step`, `train_step`) with its rows and length, and
keeps the kernel counters' change over the call (`kernels.ops.launch_counts`);
the train step's `forward` and `backward` spans wrap each micro-batch's loss
and gradient.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import launch_counts
from repro_torch.launch.presets import StepSettings
from repro_torch.models import api as model_api
from repro_torch.models.meta import leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.scope import scope, span, step as step_record


def _step(kind, tokens, length=None):
    """The step record of a call on `tokens` [B, S] (`length` S unless given)."""
    return step_record(kind, tokens.shape[0], tokens.shape[1] if length is None else length,
                       launch_counts)


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
    `accum_dtype` before it is added, and the loss the mean of theirs.
    DTensor gradients are synchronised as backward makes them (each
    micro-batch's, before its term is cast and added)."""
    def loss_and_grads(params, micro):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        for t, p in zip(leaves(live), leaves(params)):
            if isinstance(p, DTensor):
                t.register_hook(functools.partial(_sync_grad, p=p))
        with span("forward"):
            loss = model_api.loss_fn(cfg, live, micro, attn_impl=st.attn_impl, remat=st.remat)
        with span("backward"):
            grads = torch.autograd.grad(loss, list(leaves(live)), materialize_grads=True)
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        with _step("train", batch["tokens"]):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if st.accum > 1:
            acc_dt = getattr(torch, st.accum_dtype)
            grads, loss = None, 0.0
            for micro in _split_micro(batch, st.accum):
                l, g = loss_and_grads(params, micro)
                g = [(gi / st.accum).to(acc_dt) for gi in g]
                # the first term as it is: 0 + x is x
                grads = g if grads is None else [a + gi for a, gi in zip(grads, g)]
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


def _sync_grad(g, *, p):
    """The hook on a DTensor param's gradient: `g` redistributed to the
    param's placements under the `grad_sync` scope.  A whole gradient is
    first cut locally where the param is sharded, then the mesh dims are
    reduced one at a time, the innermost (`model`) first, so that the
    reduction over `data` moves only what the param keeps of it."""
    target = list(p.placements)
    steps = [[t if c.is_replicate() and t.is_shard() else c
              for c, t in zip(g.placements, target)]]
    for d in reversed(range(len(target))):
        steps.append(steps[-1][:d] + [target[d]] + steps[-1][d + 1:])
    with scope("grad_sync"):
        for placements in steps:
            if tuple(placements) != tuple(g.placements):
                g = g.redistribute(p.device_mesh, placements)
    return g


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
        with _step("prefill", batch["tokens"]):
            return model_api.prefill(cfg, params, batch, attn_impl=st.attn_impl,
                                     cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg):
    """The reference's factory also takes a `StepSettings` and reads none of
    it (decode attention is always naive), so the port's takes none.  Its
    step record's length is the positions attended, pos + 1."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos, positions=None):
        with _step("decode", tokens, pos + 1):
            return model_api.decode_step(cfg, params, cache, tokens, pos,
                                         positions=positions)
    return decode_step
