#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port on the card(s) of this machine.

    python3 perfbench/run.py --workload chatglm3-6b.prefill-long --seed 7 \
        --seconds 40 --trace 0

from the root of a checkout.  It prints the card's name, power limit and the
seed first, the numbers that decide `correct` beside their limits as the last
lines of standard error, and one JSON object as the last line of standard
output.  With no CUDA card, or fewer than the cell asks for, or outside a
checkout that holds the program, it exits non-zero and prints no result."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run lives at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    # the card's name and power limit, read while the imports run; waited for
    # before the result is printed
    try:
        SMI = subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, text=True)
    except OSError as e:
        SMI = e
    from perfbench.harness.main import main
    sys.exit(main(sys.argv[1:], T_START, SMI))
