"""qwen3-moe-235b-a22b — 128-expert top-8 MoE. [hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,              # q_dim 8192 > d_model (qwen3 style)
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    notes="128 experts over 16-way model axis => 8 experts/shard (pure EP)",
)
