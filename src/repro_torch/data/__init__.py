"""Deterministic synthetic token stream (the port of the reference's `repro.data`)."""
from repro_torch.data.pipeline import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens"]
