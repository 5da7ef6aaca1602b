"""`elementwise_share.prefill` (metrics/elementwise_share.prefill.py) in the cells that report
`prefill_tokens_per_s.ssm`."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("elementwise_share.prefill.py")))["read"]
