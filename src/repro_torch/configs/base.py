"""Config system: model architecture configs + input-shape specs.

The port's own copy of the reference's `configs/base.py` (the port imports
nothing of `repro`).  Fields and defaults are identical, so a config built
here and one built in the reference compare equal field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (superset over all assigned families)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # normalization / activation
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    glu: bool = True               # gated (SwiGLU/GeGLU) vs plain MLP
    sandwich_norm: bool = False    # gemma3-style post-block norms
    qk_norm: bool = False          # qwen3-style per-head q/k RMSNorm

    # position encoding
    rope: str = "standard"         # standard | partial | mrope | learned | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # fraction of head_dim rotated (chatglm: 0.5)
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl (t, h, w) sections

    # attention locality
    window: int = 0                # 0 = full attention; >0 = sliding window
    # per-layer window pattern; e.g. gemma3: 5 local layers then 1 global.
    # tuple of (window_or_0) with len == num_layers, or () = uniform.
    window_pattern: Tuple[int, ...] = ()

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 512      # routing-group tokens (dispatch ~ Sg^2)
    moe_table_dtype: str = "float32"   # dispatch/combine one-hot tensors
    moe_dispatch: str = "einsum"   # einsum (GShard baseline) | sort (EP)

    # SSM scan scheduling: precompute a_bar/bx for the full sequence or
    # per-chunk inside the scan (16x smaller live tensors)
    ssm_inloop: bool = False

    # SSM (mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    source_len: int = 0            # fixed encoder length (whisper: 1500 frames)

    # embeddings
    tie_embeddings: bool = False
    max_positions: int = 32768     # learned-position table bound (whisper)

    # dtypes (strings to keep config hashable / serializable)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # notes for DESIGN.md §Arch-applicability
    notes: str = ""

    # ---- derived helpers -------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window sizes (0 = full attention)."""
        if self.window_pattern:
            assert len(self.window_pattern) == self.num_layers
            return self.window_pattern
        return (self.window,) * self.num_layers

    @property
    def is_subquadratic(self) -> bool:
        """True if long-context decode is architecturally bounded.

        SSM / hybrid state is O(1); SWA archs retain a bounded KV window.
        gemma3 counts: only 1-in-6 layers is global.  Pure full-attention
        archs (and enc-dec audio) are excluded per the assignment.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "encdec":
            return False
        windows = self.layer_windows()
        return any(w > 0 for w in windows)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    # decode with windowed KV retention (long_500k on SWA archs keeps only
    # the attention-reachable window per local layer).
    windowed_cache: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, windowed_cache=True),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (config, shape) cell runs, and the reason when skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        if cfg.family == "encdec":
            return False, ("enc-dec audio: source fixed at %d frames, decoder "
                           "context <=448; 500k decode undefined" % cfg.source_len)
        return False, "pure full-attention arch: unbounded KV at 500k ctx (skip per assignment)"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window_pattern=(),
        window=16 if cfg.window or cfg.window_pattern else 0,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=min(2, cfg.top_k), moe_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=4, d_conv=4, expand=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, source_len=24, max_positions=128)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    return cfg.replace(**kw)
