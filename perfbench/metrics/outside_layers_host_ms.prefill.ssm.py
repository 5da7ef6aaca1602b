"""`outside_layers_host_ms.prefill` (metrics/outside_layers_host_ms.prefill.py)
in the cells that report `ttft_p95_ms.ssm`."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("outside_layers_host_ms.prefill.py")))["read"]
