"""Per-step execution settings (from the reference `launch/presets.py`).

The reference's `StepSettings` also carries training, sharding and MoE
fields (accumulation, remat, optimizer dtypes, sequence sharding, FSDP/HSDP
placement, MoE dispatch); nothing in this serving slice on one card reads
them, so each comes back with the slice that ports the code reading it.
`attn_impl` takes the port's names: auto | naive | blocked | flash.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StepSettings:
    attn_impl: str = "auto"        # auto | naive | blocked | flash
