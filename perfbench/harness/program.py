"""The system under test, the PyTorch port (`repro_torch`): the only module of
the benchmark that imports it.  The benchmark takes from it the entry points
the window drives, the params tree's shapes and its launch counters."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention, mamba_scan
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_prefill_step
from repro_torch.launch.train import Trainer
from repro_torch.models import api
from repro_torch.optim import adamw

COUNTERS = {"k1": flash_attention, "k2": mamba_scan}


def model_config(config):
    """The program's config from a configuration file's "model" block."""
    return ModelConfig(**config["model"])


def param_specs(cfg, dtype):
    """The params tree as (shape, dtype) leaves, as the program would make it."""
    return api.abstract_params(cfg, dtype)


def prefill_step(cfg, length):
    """The serving path's prefill with K1 (`attn_impl="flash"`) and a cache of
    length + 1 positions (room for the first decode step)."""
    return make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=length + 1)


def trainer(cfg, traffic, device):
    """The Trainer whose `step` the window drives, and its optimizer state's maker."""
    o = traffic["optimizer"]
    opt_cfg = adamw.AdamWConfig(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"],
                                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                                warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                                min_lr_ratio=o["min_lr_ratio"])
    tr = Trainer(cfg, steps=o["total_steps"], batch=traffic["rows"], seq=traffic["seq"],
                 settings=StepSettings(accum=traffic["accum"], remat=traffic["remat"]),
                 opt_cfg=opt_cfg, device=device)
    return tr, lambda params: adamw.init(opt_cfg, params)


def zero_launches():
    for mod in COUNTERS.values():
        mod.launches = 0


def launches():
    return {name: mod.launches for name, mod in COUNTERS.items()}
