"""chatglm3-6b — dense GQA decoder with 2d (partial) RoPE. [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope="partial",
    rope_fraction=0.5,         # 2d rope: rotate half of head_dim
    notes="pure full attention => long_500k skipped per assignment",
)
