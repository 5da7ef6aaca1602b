"""`layer_host_ms.prefill` (metrics/layer_host_ms.prefill.py) in the cells that
report `ttft_p95_ms.ssm`."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("layer_host_ms.prefill.py")))["read"]
