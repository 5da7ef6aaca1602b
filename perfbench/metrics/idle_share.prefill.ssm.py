"""`idle_share.prefill` (metrics/idle_share.prefill.py) in the cells that report
`ttft_p95_ms.ssm`."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("idle_share.prefill.py")))["read"]
