"""h2o-danube-3-4b — llama+mistral mix dense decoder with SWA. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,              # 3840/32 — NOT 128-aligned; einsum attention path
    d_ff=10240,
    vocab_size=32000,
    window=4096,               # mistral-style sliding window
    notes="head_dim 120 is not MXU-aligned: flash kernel pads to 128",
)
