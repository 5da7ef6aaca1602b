"""Architecture registry.  Only the archs whose slice is ported are listed."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, smoke_config
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3_6b
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba_7b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b

ARCHS = {cfg.name: cfg for cfg in (_chatglm3_6b, _falcon_mamba_7b, _hymba_1_5b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "smoke_config"]
