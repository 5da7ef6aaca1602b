"""whisper-tiny — enc-dec audio transformer backbone. [arXiv:2212.04356]

The port's copy of the reference's config.  The conv frontend is a stub:
the model takes precomputed frame embeddings (batch, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    glu=False,
    rope="learned",            # whisper uses learned absolute positions
    source_len=1500,           # 30 s of audio at 50 frames/s
    tie_embeddings=True,       # whisper ties decoder embed and output head
    notes="conv frontend stubbed: precomputed frame embeddings as input; "
          "position table sized for the assigned decode_32k shape "
          "(real whisper caps targets at 448)",
)
