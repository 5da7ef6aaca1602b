"""Per-step execution settings (from the reference `launch/presets.py`).

`attn_impl` takes the port's names: auto | naive | blocked | flash.  Of
the reference's sharding fields the port has `seq_shard`, which `Trainer`
passes to `activation_sharding`.  The MoE group size and dispatch are the
config's (`cfg.moe_group_size`, `cfg.moe_dispatch`, which `models.moe`
reads); serving placement (`serve_fsdp`) and HSDP come with the slices
that read them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StepSettings:
    accum: int = 1                 # gradient-accumulation micro-batches
    remat: str = "full"            # none | dots | full
    attn_impl: str = "auto"        # auto | naive | blocked | flash
    opt_state_dtype: str = "float32"
    accum_dtype: str = "float32"   # gradient-accumulator dtype
    seq_shard: bool = False        # Megatron-SP residual sequence sharding
    grad_compression: str = "none"   # none | bf16: a bf16 round trip of the gradient


# train_4k accumulation per arch, the reference's table (sized there for its
# chips under sharding; the dry-run slice derives the card's own)
_TRAIN_ACCUM = {
    "llama3-405b": 16,
    "mixtral-8x22b": 16,
    "qwen3-moe-235b-a22b": 16,
    "falcon-mamba-7b": 8,
    "chatglm3-6b": 4,
    "gemma3-4b": 4,
    "h2o-danube-3-4b": 4,
    "hymba-1.5b": 2,
    "qwen2-vl-2b": 2,
    "whisper-tiny": 1,
}

# frontier configs: bf16 moments and bf16 gradient accumulation
_BIG = ("llama3-405b", "qwen3-moe-235b-a22b", "mixtral-8x22b")


def settings_for(arch: str, shape_name: str) -> StepSettings:
    if shape_name == "train_4k":
        big = arch in _BIG
        return StepSettings(
            accum=_TRAIN_ACCUM.get(arch, 4),
            remat="full",
            opt_state_dtype="bfloat16" if big else "float32",
            accum_dtype="bfloat16" if big else "float32",
        )
    # serving shapes: no accumulation or remat
    return StepSettings(accum=1, remat="none")
