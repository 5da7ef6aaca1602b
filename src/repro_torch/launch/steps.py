"""Step factories for serving: prefill and decode.

The reference's factories return jittable pure functions; here they return
plain callables that run eagerly under `torch.no_grad`.
"""
from __future__ import annotations

import torch

from repro_torch.launch.presets import StepSettings
from repro_torch.models import api as model_api


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
