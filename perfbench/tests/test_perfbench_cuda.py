"""On the card: one short run of each cell through the command line, its last
line a result with every end-to-end metric.  Skips where there is no card."""
import json
import subprocess
import sys

import pytest

from perfbench.tests.helpers import ROOT


def workloads():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_short_run_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                          "3000000007", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and "setup_s" in res["metrics"]
