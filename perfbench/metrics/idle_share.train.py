"""`idle_share.prefill` (metrics/idle_share.prefill.py) in the cells that report
`train_tokens_per_s`: the share of the traced window in which nothing ran on
the device."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("idle_share.prefill.py")))["read"]
