"""Training-loop support: the straggler watchdog."""
from repro_torch.training.watchdog import StepStats, StragglerWatchdog

__all__ = ["StragglerWatchdog", "StepStats"]
