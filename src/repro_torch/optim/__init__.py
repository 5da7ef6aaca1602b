"""AdamW, written out (the port of the reference's `repro.optim`)."""
from repro_torch.optim.adamw import AdamWConfig, global_norm, init, schedule, update

__all__ = ["AdamWConfig", "init", "update", "schedule", "global_norm"]
