"""Atomic, resumable checkpoints (the port of the reference's `repro.checkpoint`)."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step, prune_old,
                                          restore, save)

__all__ = ["save", "restore", "latest_step", "prune_old", "AsyncCheckpointer"]
