"""`k2_roofline` (metrics/k2_roofline.py) in the hybrid cell, where it moves
`ttft_p95_ms`: one fused K2 call a layer and request, beside K1."""
import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("k2_roofline.py")))["read"]
