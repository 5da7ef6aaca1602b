"""Per-step execution settings (from the reference `launch/presets.py`).

`attn_impl` takes the port's names: auto | naive | blocked | flash.  The
reference's sharding fields: `seq_shard`, which `Trainer` and the dry-run
pass to `activation_sharding`; `serve_fsdp` and `hsdp`, which the dry-run
reads to pick the rule table (`launch/dryrun.py`, set by its `--serve-fsdp`
and `--hsdp` flags or by a caller's `settings`).  The MoE group size and
dispatch are the config's (`cfg.moe_group_size`, `cfg.moe_dispatch`, which
`models.moe` reads).

`settings_for` is the reference's table, sized there for its 16 GB chips;
the dry-run holds the same steps against the H100's 80 GB, so each cell is
the same step in both packages.
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
    # serving weight placement: None = auto (FSDP iff the weights do not fit
    # replicated over data), True/False forces it
    serve_fsdp: "bool | None" = None
    # HSDP: shard params within the pod, replicate across pods (multi-pod only)
    hsdp: bool = False


# train_4k accumulation per arch, the reference's table (sized there for its
# chips under sharding)
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
