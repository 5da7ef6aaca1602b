"""qwen2-vl-2b — VLM backbone with M-RoPE. [arXiv:2409.12191]

Vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings alongside text tokens; M-RoPE takes (3, seq)
position ids (t / h / w).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope="mrope",
    mrope_sections=(16, 24, 24),   # t/h/w sections of head_dim/2
    rope_theta=1_000_000.0,
    notes="backbone only; patch embeddings precomputed (stub frontend); "
          "pure full attention => long_500k skipped per assignment",
)
