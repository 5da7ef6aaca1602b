"""The hybrid cell's yardstick: K1's pairs under a causal mask and a window
against a count of the mask itself, hymba-1.5b's matmul weights against the
port's, and the readers `k1_roofline.hybrid` and `ssm_host_ms.prefill.hybrid`
on hand-made step records, on a program without the window counter, and on a
small traced run."""
import importlib.util
import json
import math
import time
from collections import deque
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import main
from perfbench.harness.prefill import Window
from perfbench.roofline import hybrid, k1, k1_window, model
from perfbench.tests.helpers import ROOT, WINDOW_S, small_cell
from repro_torch import scope as port_scope

COUNTER = "flash_attention.window_launches"


def reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("S,w", [(1, 0), (7, 0), (16, 4), (17, 4), (37, 5), (64, 16),
                                 (100, 99), (100, 100), (12, 40), (1000, 1)])
def test_k1_window_pairs_count_the_mask(S, w):
    i, j = torch.arange(S)[:, None], torch.arange(S)[None]
    keep = (j <= i) & ((i - j < w) if w else True)
    assert k1_window.pairs(S, w) == int(keep.sum())


def test_k1_window_without_a_window_is_k1():
    assert k1_window.counts(4, 32, 2, 1024, 128, 0) == k1.counts(4, 32, 2, 1024, 128)
    assert k1_window.bound_s(4, 32, 2, 1024, 128, 4096) == k1.bound_s(4, 32, 2, 1024, 128)


def test_hymba_window_keeps_a_quarter_of_the_causal_pairs_at_7936():
    """At the longest prompt a window of 1024 keeps 7.6 M of the 31.5 M pairs."""
    assert k1_window.pairs(7936, 1024) == 1024 * 1025 // 2 + 6912 * 1024 == 7_602_688
    assert k1.causal_pairs(7936) == 31_494_016


def test_hymba_param_count_matches_port():
    from perfbench.harness import program
    from perfbench.reference.common import flat
    from repro_torch.models import api
    m = json.loads((ROOT / "perfbench" / "configs" / "hymba-1.5b.json").read_text())["model"]
    cfg = program.model_config({"model": m})
    # the port's N also counts the weights no matmul reads: norms, the conv, A, D, biases
    other = sum(math.prod(spec.shape) for path, spec in flat(api.abstract_params(cfg))
                if path[-1] in ("scale", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip"))
    assert model.flops_param_count(m) == api.flops_param_count(cfg) - other


def test_hybrid_attention_flops_sum_the_window_pattern():
    m = {"num_layers": 3, "num_heads": 2, "head_dim": 8, "window_pattern": [4, 0, 4]}
    assert hybrid.attention_flops(m, 10, 3) == 4 * 2 * 8 * (2 * (10 + 6 * 4) + 55) * 3
    assert hybrid.attention_flops(dict(m, window_pattern=[], window=0), 10, 1) == \
        4 * 2 * 8 * 3 * 55


# the hand-worked case: 3 layers (window 1024, global, window 1024), 8 query
# heads on 1 KV head of 64, two traced requests of 4096 tokens; each call is
# bound by its operations, 4·64·8 = 2048 a kept pair
HAND = {"num_layers": 3, "num_heads": 8, "num_kv_heads": 1, "head_dim": 64,
        "window_pattern": [1024, 0, 1024]}
K1_S = 1e-4


def hand_ctx(monkeypatch, launches=6, windowed=(2, 2), counters=True):
    lengths, traced = [2048, 4096, 4096, 2048], [False, True, True, False]
    win = Window(rows=[1] * 4, lengths=lengths, traced=traced)
    log = deque([port_scope.StepRecord(
        20 + i, "prefill", 1, n, t, spans={"prefill_step": (1, 1, 1)},
        counters={COUNTER: windowed[0] if i == 1 else windowed[1]} if counters and t else {})
        for i, (n, t) in enumerate(zip(lengths, traced))])
    monkeypatch.setattr(port_scope, "steps", log)
    summary = SimpleNamespace(time=lambda pred: K1_S if pred("flash_fwd_wgmma_kernel") else 0.0)
    return SimpleNamespace(model=HAND, traffic={"kind": "prefill"}, summary=summary,
                           launches={"k1": launches, "k2": 0}, window=win,
                           traced=[(1, 4096), (1, 4096)], untraced=[])


def test_k1_roofline_hybrid_hand_worked(monkeypatch):
    ideal = 2 * 2048 * (2 * 3_670_528 + 8_390_656) / 989e12
    assert reader("k1_roofline.hybrid")(hand_ctx(monkeypatch)) == pytest.approx(
        100 * ideal / K1_S, rel=1e-12)


@pytest.mark.parametrize("launches,windowed", [(5, (2, 2)), (7, (2, 2)), (6, (3, 2)),
                                               (6, (2, 0))])
def test_k1_roofline_hybrid_raises_on_a_wrong_count(monkeypatch, launches, windowed):
    with pytest.raises(RuntimeError):
        reader("k1_roofline.hybrid")(hand_ctx(monkeypatch, launches, windowed))


def test_k1_roofline_hybrid_reads_nothing_without_the_counter(monkeypatch):
    """A program without `flash_attention.window_launches` (the parent of the
    change that adds it), or without step records: nothing read, nothing raised."""
    assert reader("k1_roofline.hybrid")(hand_ctx(monkeypatch, counters=False)) is None
    ctx = hand_ctx(monkeypatch)
    monkeypatch.delattr(port_scope, "steps")
    assert reader("k1_roofline.hybrid")(ctx) is None


def test_ssm_host_ms_reads_the_untraced_requests_and_checks_the_count(monkeypatch):
    win = Window(rows=[1] * 3, lengths=[16, 32, 48], traced=[False, True, False])
    ctx = SimpleNamespace(window=win, traffic={"kind": "prefill"}, model={"num_layers": 2})
    ms = 1_000_000
    log = deque(port_scope.StepRecord(30 + i, "prefill", 1, n, t,
                                      spans={"ssm": (2, int(x * ms), 0)})
                for i, (n, t, x) in enumerate(zip(win.lengths, win.traced, (4, 500, 8))))
    monkeypatch.setattr(port_scope, "steps", log)
    assert reader("ssm_host_ms.prefill.hybrid")(ctx) == pytest.approx((4 + 8) / 4)
    log[-1].spans["ssm"] = (1, 8 * ms, 0)
    with pytest.raises(RuntimeError):
        reader("ssm_host_ms.prefill.hybrid")(ctx)
    monkeypatch.delattr(port_scope, "steps")
    assert reader("ssm_host_ms.prefill.hybrid")(ctx) is None


def test_hybrid_readers_on_a_small_traced_run(cpu):
    """A traced run of the small hybrid cell with the cell's own readers: the
    CPU runs no K1 or K2 kernel, so their rooflines read nothing; the host
    spans read every untraced request, the Mamba branch inside the layer."""
    from perfbench.harness import spec
    real = spec.cell(spec.load_spec(), "hymba-1.5b.prefill-long")
    cell = small_cell("tiny-hybrid", "tiny-prefill", limits={"logits_rel": 1, "cache_rel": 1},
                      per_layer=real.per_layer)
    out, _ = main.measure(cell, SimpleNamespace(seed=2 ** 31 + 17, seconds=WINDOW_S, trace=1),
                          cpu, time.perf_counter())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "k1_roofline.hybrid" not in m and "k2_roofline.hybrid" not in m
    assert 0 < m["ssm_host_ms.prefill.hybrid"] < m["layer_host_ms.prefill"]
    assert {"idle_share.prefill", "dispatch_ms.prefill", "outside_layers_host_ms.prefill"} <= set(m)
