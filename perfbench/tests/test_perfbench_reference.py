"""The references against the port at small width, in float32 on the CPU:
the prefill's logits and cache, and three train steps' losses, first
gradients and changes, as a run compares them."""
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.helpers import WINDOW_S, small_cell

FP32 = 1e-5     # float32 against float32: the order of the sums alone differs


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-ssm"])
def test_prefill_reference_matches_port_fp32(config, cpu):
    from perfbench.harness import prefill
    res = prefill.run(small_cell(config, "tiny-prefill", compute_dtype="float32"), 11, WINDOW_S,
                      False, cpu, time.perf_counter())
    assert len(res["checked"]) >= 3
    assert res["readings"]["logits_rel"] < FP32
    assert res["readings"]["cache_rel"] < FP32


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-ssm"])
def test_train_reference_matches_port_fp32(config, cpu):
    from perfbench.harness import train
    res = train.run(small_cell(config, "tiny-train", compute_dtype="float32"), 12, 0.0, False,
                    cpu, time.perf_counter())
    assert len(res["program"]["loss"]) == 3
    for name, value in res["readings"].items():
        assert value < FP32, (name, value)


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-ssm"])
def test_bf16_program_reads_above_fp32_and_below_control(config, cpu):
    """The served precision reads above float32's rounding, and the float8
    control reads higher still: the comparison sees precision."""
    from perfbench.harness import prefill
    cell = small_cell(config, "tiny-prefill")
    prog = prefill.run(cell, 13, WINDOW_S, False, cpu, time.perf_counter())["readings"]
    low = prefill.control(cell, 13, cpu)
    assert 1e-4 < prog["logits_rel"] < low["logits_rel"] / 3


def test_ssm_two_level_scan_matches_sequential(cpu):
    from perfbench.reference.ssm import scan
    g = torch.Generator().manual_seed(0)
    B, S, D, N = 2, 150, 8, 4
    delta = torch.rand(B, S, D, generator=g) * 0.5
    x, b, c = (torch.randn(B, S, k, generator=g) for k in (D, N, N))
    a = -torch.rand(D, N, generator=g) * 3
    y, h = scan(delta, x, a, b, c, chunk=16)
    hs = torch.zeros(B, D, N)
    ys = []
    for t in range(S):
        hs = torch.exp(delta[:, t, :, None] * a) * hs + (delta[:, t] * x[:, t])[..., None] * b[:, t, None]
        ys.append(torch.einsum("bdn,bn->bd", hs, c[:, t]))
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hs, rtol=1e-5, atol=1e-5)


def test_measure_reports_a_result_line_on_cpu(cpu):
    """The rest of a run past the look for a card: end-to-end metrics, checks last."""
    from perfbench.harness import main, spec
    s = spec.load_spec()
    cell = small_cell("tiny-dense", "tiny-prefill", limits={"logits_rel": 1, "cache_rel": 1})
    cell.end_to_end = [m for m in s["end_to_end"] if m["name"] in
                       ("prefill_tokens_per_s", "ttft_p95_ms", "setup_s")]
    out, _ = main.measure(cell, SimpleNamespace(seed=2 ** 31 + 99, seconds=WINDOW_S, trace=0), cpu,
                          time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 3
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(v["value"] > 0 for v in out["metrics"].values())
