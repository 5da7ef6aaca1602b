"""hymba-1.5b — hybrid: parallel attention + mamba heads. [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig

# SWA everywhere except full attention at first / middle / last layers.
_PATTERN = tuple(0 if i in (0, 15, 31) else 1024 for i in range(32))

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    window_pattern=_PATTERN,
    ssm_state=16,
    d_conv=4,
    expand=2,
    notes="parallel attn+mamba per block, mean-fused; meta-tokens omitted "
          "(orthogonal to communication behavior)",
)
