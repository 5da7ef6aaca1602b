"""falcon-mamba-7b — attention-free Mamba-1 LM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # attention-free, no separate MLP (mamba block only)
    vocab_size=65024,
    rope="none",
    ssm_state=16,
    d_conv=4,
    expand=2,                  # d_inner = 8192
    notes="mamba-1 blocks only; O(1) state => long_500k applicable",
)
