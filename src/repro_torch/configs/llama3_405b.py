"""llama3-405b — frontier-scale dense GQA decoder. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    notes="pure full attention => long_500k skipped per assignment; "
          "train_4k requires grad accumulation + full remat on 256 chips",
)
