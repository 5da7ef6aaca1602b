"""Architecture registry: the reference registry's 10 archs."""
from repro_torch.configs.base import (SHAPE_ORDER, SHAPES, ModelConfig, ShapeSpec,
                                      shape_applicable, smoke_config)
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3_6b
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba_7b
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3_4b
from repro_torch.configs.h2o_danube3_4b import CONFIG as _h2o_danube3_4b
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral_8x22b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.whisper_tiny import CONFIG as _whisper_tiny

ARCHS = {cfg.name: cfg for cfg in (
    _whisper_tiny, _falcon_mamba_7b, _mixtral_8x22b, _qwen3_moe, _chatglm3_6b, _llama3_405b,
    _gemma3_4b, _h2o_danube3_4b, _hymba_1_5b, _qwen2_vl_2b)}

ARCH_ORDER = tuple(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ARCH_ORDER", "SHAPES", "SHAPE_ORDER", "ModelConfig", "ShapeSpec",
           "get_config", "shape_applicable", "smoke_config"]
