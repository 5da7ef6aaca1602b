"""mixtral-8x22b — sparse MoE decoder, 8 experts top-2, SWA. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,                # dense d_ff unused; experts use moe_d_ff
    vocab_size=32768,
    rope_theta=1_000_000.0,
    window=4096,               # sliding-window attention
    num_experts=8,
    top_k=2,
    moe_d_ff=16384,
    notes="every layer MoE; 8 experts < model axis (16) => expert-TP sharding",
)
