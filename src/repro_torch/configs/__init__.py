"""Architecture registry.  Only the archs whose slice is ported are listed."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, smoke_config
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3_6b

ARCHS = {cfg.name: cfg for cfg in (_chatglm3_6b,)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "smoke_config"]
