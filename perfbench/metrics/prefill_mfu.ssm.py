"""`prefill_mfu` (metrics/prefill_mfu.py) in the cells that report
`prefill_tokens_per_s.ssm`."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("prefill_mfu.py")))["read"]
