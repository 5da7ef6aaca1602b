"""Per-step execution settings (from the reference `launch/presets.py`).

`attn_impl` takes the port's names: auto | naive | blocked | flash.  The
reference's sharding fields: `seq_shard`, which `Trainer` and the dry-run
pass to `activation_sharding`; `serve_fsdp` and `hsdp`, which the dry-run
reads to pick the rule table (`launch/dryrun.py`, set by its `--serve-fsdp`
and `--hsdp` flags or by a caller's `settings`).  The MoE group size and
dispatch are the config's (`cfg.moe_group_size`, `cfg.moe_dispatch`, which
`models.moe` reads).

`settings_for` is the reference's table, sized there for its 16 GB chips
on a (16, 16) mesh; the parity tests hold the port's steps against the
reference's with it.  `h100_settings_for` is the row the dry-run prices on
the port's meshes and an 80 GB H100: the reference's row with the
accumulation capped so that every data rank keeps a row of each
micro-batch (see its docstring).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping

from repro_torch.configs import SHAPES


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


def h100_settings_for(arch: str, shape_name: str,
                      mesh_sizes: Mapping[str, int]) -> StepSettings:
    """The reference's row fitted to an 80 GB H100 on a mesh of `mesh_sizes`
    ({axis: size}).

    accum: the reference's, at most global_batch / (data x pod), so that each
    micro-batch splits over every data rank (train_4k's 256 rows: at most 8 on
    (32, 8), 4 on (2, 32, 8)).  The reference's accum 16 for the frontier archs
    was sized for 16 GB chips on a 16-way `data`; on the port's 32- and 64-way
    `data` it leaves micro-batches that cannot split, and every data rank
    then computes the whole micro-batch.
    remat "full" and the moment and accumulator dtypes (bf16 for the frontier
    archs, fp32 else) stay the reference's: with them the analytic model of
    every cell fits 80 GB with room for the eager step's temporaries, which
    the fake peak counts and the analytic model does not.
    Serving rows are the reference's."""
    st = settings_for(arch, shape_name)
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        return st
    data = mesh_sizes.get("data", 1) * mesh_sizes.get("pod", 1)
    return replace(st, accum=max(1, min(st.accum, shape.global_batch // data)))
