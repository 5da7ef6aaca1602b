"""gemma3-4b — dense decoder, 5:1 local:global attention. [hf:google/gemma-3]"""
from repro_torch.configs.base import ModelConfig

_LOCAL_WINDOW = 1024
# 5 local layers then 1 global, repeating (global at layers 5, 11, 17, 23, 29).
_PATTERN = tuple(0 if (i % 6) == 5 else _LOCAL_WINDOW for i in range(34))

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,              # q_dim 2048 != d_model (gemma style)
    d_ff=10240,
    vocab_size=262144,
    act="gelu",
    sandwich_norm=True,
    rope_theta=1_000_000.0,
    window_pattern=_PATTERN,
    notes="5:1 local:global; long_500k retains windowed KV on local layers, "
          "full (sharded) KV on the 5 global layers",
)
