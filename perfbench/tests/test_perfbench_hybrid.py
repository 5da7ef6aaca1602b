"""The hybrid family (hymba-1.5b) against its plain reference at small width
on the CPU: the prefill's logits and every layer's k, v, conv and SSM state in
float32, the served bfloat16 between float32's rounding and both float8
controls, and four decode steps through the port's cache against the
reference's full forward at each position.  Windows of 16 in two of three
layers, on prompts longer than the window."""
import dataclasses
import json
import time

import pytest
import torch

from perfbench.tests.helpers import ROOT, WINDOW_S, small_cell

FP32 = 1e-5     # float32 against float32: the order of the sums alone differs


def test_hybrid_prefill_reference_matches_port_fp32(cpu):
    from perfbench.harness import prefill
    cell = small_cell("tiny-hybrid", "tiny-prefill", compute_dtype="float32")
    res = prefill.run(cell, 11, WINDOW_S, False, cpu, time.perf_counter())
    assert len(res["checked"]) >= 3
    assert res["readings"]["logits_rel"] < FP32
    assert res["readings"]["cache_rel"] < FP32


@pytest.mark.parametrize("prec", ["fp8", "fp8_gemm"])
def test_hybrid_bf16_program_reads_above_fp32_and_below_control(prec, cpu):
    """The served precision reads above float32's rounding, and each float8
    control at least 3x higher on both numbers: the comparison sees precision."""
    from perfbench.harness import prefill
    cell = small_cell("tiny-hybrid", "tiny-prefill")
    prog = prefill.run(cell, 13, WINDOW_S, False, cpu, time.perf_counter())["readings"]
    low = prefill.control(cell, 13, cpu, prec)
    for name in ("logits_rel", "cache_rel"):
        assert 1e-4 < prog[name] < low[name] / 3, (name, prog[name], low[name])


def test_hybrid_decode_through_the_cache_matches_reference_forward(cpu):
    """Prefill 40 tokens (over twice the window) with K1's path, then decode 4
    tokens through the port's cache: each step's logits are the reference's
    last-position logits of the whole sequence so far."""
    from perfbench.harness import prefill, program
    from perfbench.reference import hybrid
    from repro_torch.models import api
    cell = small_cell("tiny-hybrid", "tiny-prefill", compute_dtype="float32")
    cfg = program.model_config(cell.config)
    w = prefill.serving_weights(cell, 21, cpu)
    g = torch.Generator().manual_seed(21)
    S, steps = 40, 4
    tokens = torch.randint(0, cfg.vocab_size, (2, S + steps), generator=g)
    with torch.no_grad():
        logits, cache = api.prefill(cfg, w, {"tokens": tokens[:, :S]}, attn_impl="flash",
                                    cache_len=S + steps)
        ref, _ = hybrid.prefill(cell.config["model"], w, tokens[:, :S])
        assert float((logits[:, -1] - ref).norm() / ref.norm()) < FP32
        for pos in range(S, S + steps):
            logits, cache = api.decode_step(cfg, w, cache, tokens[:, pos:pos + 1], pos)
            ref, _ = hybrid.prefill(cell.config["model"], w, tokens[:, :pos + 1])
            assert float((logits[:, -1] - ref).norm() / ref.norm()) < FP32, pos


def test_hybrid_attention_keeps_only_the_window():
    """The blocked windowed attention against one dense masked softmax, with
    blocks smaller than the sequence, a window that does not divide it, and
    window 0 (causal alone)."""
    from perfbench.reference import hybrid
    g = torch.Generator().manual_seed(3)
    B, S, H, K, dh = 2, 37, 4, 2, 8
    q, k, v = (torch.randn(B, S, n, dh, generator=g) for n in (H, K, K))
    saved = hybrid.Q_BLOCK
    hybrid.Q_BLOCK = 8
    try:
        for window in (0, 5, 16, 64):
            got = hybrid.attention({}, q, k, v, window)
            i, j = torch.arange(S)[:, None], torch.arange(S)[None]
            keep = (j <= i) & ((i - j < window) if window else True)
            kk, vv = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
            scores = torch.einsum("bqhd,bshd->bhqs", q, kk) * dh ** -0.5
            probs = scores.masked_fill(~keep, float("-inf")).softmax(-1)
            want = torch.einsum("bhqs,bshd->bqhd", probs, vv).reshape(B, S, H * dh)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        hybrid.Q_BLOCK = saved


def test_hymba_configuration_file_is_the_ports_configuration():
    """Every field of the file's model block is the registry's hymba-1.5b, the
    window pattern too (a JSON list there, a tuple in the registry); no depth
    is cut."""
    from perfbench.harness import program
    from repro_torch.configs import get_config
    cfg = json.loads((ROOT / "perfbench" / "configs" / "hymba-1.5b.json").read_text())
    port = dataclasses.asdict(get_config("hymba-1.5b"))
    for key, value in cfg["model"].items():
        assert port[key] == (tuple(value) if isinstance(value, list) else value), key
    built = program.model_config(cfg)
    assert dataclasses.replace(built, window_pattern=tuple(built.window_pattern),
                               notes=port["notes"]) == get_config("hymba-1.5b")
    assert sum(w > 0 for w in built.layer_windows()) == 29
