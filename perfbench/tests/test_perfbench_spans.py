"""`harness/spans.py` and the readers of the port's step records: the log
aligned with a prefill and a train window, the mismatches it refuses, each
reader's mean over the untraced requests or steps alone, nothing read where
the port keeps no log, and the readers on a real run of a small cell."""
import importlib.util
import time
from collections import deque
from types import SimpleNamespace

import pytest

from perfbench.harness import main, spans
from perfbench.harness.prefill import Window as PrefillWindow
from perfbench.harness.train import Window as TrainWindow
from perfbench.tests.helpers import ROOT, WINDOW_S, small_cell
from repro_torch import scope as port_scope

MS = 1_000_000


def record(i, kind, rows, length, profiled, spans_ms):
    """A step record whose spans take the given milliseconds, inclusive."""
    return port_scope.StepRecord(
        i, kind, rows, length, profiled,
        spans={name: (count, int(ms * MS), 0) for name, (count, ms) in spans_ms.items()})


def prefill_ctx(traced, lengths, layers=2):
    win = PrefillWindow(rows=[4] * len(lengths), lengths=list(lengths), traced=list(traced))
    return SimpleNamespace(window=win, traffic={"kind": "prefill"},
                           model={"num_layers": layers})


def prefill_log(ctx, step_ms, layer_ms, first_id=10):
    """Two warm-up records, then one a request of the window; request i's step
    takes step_ms[i] and each of its layers layer_ms[i]."""
    n = ctx.model["num_layers"]
    warm = [record(1, "prefill", 4, 7, False, {"prefill_step": (1, 99.0)}),
            record(2, "train", 4, 7, False, {"train_step": (1, 99.0)})]
    recs = [record(first_id + i, "prefill", r, length, t,
                   {"prefill_step": (1, s), "layer": (n, n * lay)})
            for i, (r, length, t, s, lay) in enumerate(zip(
                ctx.window.rows, ctx.window.lengths, ctx.window.traced, step_ms, layer_ms))]
    return deque(warm + recs, maxlen=port_scope.LOG_STEPS)


def train_ctx(traced):
    win = TrainWindow(step_s=[1.0] * len(traced), traced=list(traced))
    return SimpleNamespace(window=win, traffic={"kind": "train", "rows": 4, "seq": 32},
                           model={"num_layers": 4})


def train_log(ctx, parts):
    return deque([record(50 + i, "train", 4, 32, t,
                         {"train_step": (1, sum(p.values()) + 1.0),
                          **{k: (2 if k != "optimizer" else 1, v) for k, v in p.items()}})
                  for i, (t, p) in enumerate(zip(ctx.window.traced, parts))])


def reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def test_prefill_window_takes_the_last_records(monkeypatch):
    ctx = prefill_ctx([False, True, True, False], [16, 32, 48, 64])
    monkeypatch.setattr(port_scope, "steps", prefill_log(ctx, [10, 20, 30, 40], [2, 3, 4, 5]))
    recs = spans.records(ctx)
    assert [(r.id, r.length, t) for r, t in recs] == [(10, 16, False), (11, 32, True),
                                                      (12, 48, True), (13, 64, False)]
    assert [r.id for r in spans.untraced(ctx)] == [10, 13]


def test_train_window_takes_the_last_records(monkeypatch):
    ctx = train_ctx([False, True, False])
    monkeypatch.setattr(port_scope, "steps", train_log(ctx, [{"forward": 1.0}] * 3))
    assert [(r.id, t) for r, t in spans.records(ctx)] == [(50, False), (51, True), (52, False)]


@pytest.mark.parametrize("fault", ["missing", "length", "rows", "profiled"])
def test_a_log_that_differs_from_the_window_raises(monkeypatch, fault):
    ctx = prefill_ctx([False, True, False], [16, 32, 48])
    log = prefill_log(ctx, [1, 2, 3], [0.1, 0.2, 0.3])
    last = log[-1]
    if fault == "missing":
        log = deque(list(log)[:-3] + list(log)[-2:])
        log[0].kind = "decode"           # no warm-up prefill record to stand in
    elif fault == "length":
        last.length = 47
    elif fault == "rows":
        last.rows = 3
    else:
        last.profiled = True
    monkeypatch.setattr(port_scope, "steps", log)
    with pytest.raises(RuntimeError):
        spans.records(ctx)


def test_a_train_log_one_step_short_raises(monkeypatch):
    ctx = train_ctx([False, True, False])
    monkeypatch.setattr(port_scope, "steps", train_log(ctx, [{"forward": 1.0}] * 3))
    ctx.window.step_s.append(1.0)
    ctx.window.traced.append(False)
    with pytest.raises(RuntimeError):
        spans.records(ctx)


def test_prefill_readers_read_the_untraced_requests_alone(monkeypatch):
    ctx = prefill_ctx([False, True, False], [16, 32, 48])
    # the traced request's 1000 ms would show in any mean that took it
    monkeypatch.setattr(port_scope, "steps", prefill_log(ctx, [10, 1000, 30], [2, 100, 4]))
    for suffix in ("", ".ssm"):
        assert reader("layer_host_ms.prefill" + suffix)(ctx) == pytest.approx(3.0)
        assert reader("outside_layers_host_ms.prefill" + suffix)(ctx) == pytest.approx(
            ((10 - 4) + (30 - 8)) / 2)


def test_layer_reader_checks_the_layer_count(monkeypatch):
    ctx = prefill_ctx([False], [16], layers=3)
    log = prefill_log(ctx, [10], [2])
    log[-1].spans["layer"] = (2, 4 * MS, 0)
    monkeypatch.setattr(port_scope, "steps", log)
    with pytest.raises(RuntimeError):
        reader("layer_host_ms.prefill")(ctx)


@pytest.mark.parametrize("part", ["forward", "backward", "optimizer"])
def test_train_readers_read_the_untraced_steps_alone(monkeypatch, part):
    ctx = train_ctx([False, True, False])
    parts = [{"forward": 10.0, "backward": 20.0, "optimizer": 3.0},
             {"forward": 500.0, "backward": 500.0, "optimizer": 500.0},
             {"forward": 14.0, "backward": 26.0, "optimizer": 5.0}]
    monkeypatch.setattr(port_scope, "steps", train_log(ctx, parts))
    want = (parts[0][part] + parts[2][part]) / 2
    assert reader(f"{part}_host_ms.train")(ctx) == pytest.approx(want)


NEW = ["layer_host_ms.prefill", "layer_host_ms.prefill.ssm", "outside_layers_host_ms.prefill",
       "outside_layers_host_ms.prefill.ssm", "forward_host_ms.train", "backward_host_ms.train",
       "optimizer_host_ms.train"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_is_read_where_the_port_keeps_no_log(monkeypatch, name):
    """A program without the recorder (the parent of the change that adds it):
    every new reader returns None and raises nothing."""
    monkeypatch.delattr(port_scope, "steps")
    ctx = train_ctx([False, True]) if name.endswith(".train") else prefill_ctx([False], [16])
    assert reader(name)(ctx) is None


def test_readers_on_a_small_prefill_run(cpu):
    """A traced run of a small dense cell: the new readers read every untraced
    request, and each request's step span lies inside the benchmark's own
    dispatch span around the same call."""
    per_layer = [{"name": n, "unit": "ms"} for n in
                 ("layer_host_ms.prefill", "outside_layers_host_ms.prefill", "dispatch_ms.prefill")]
    cell = small_cell("tiny-dense", "tiny-prefill", limits={"logits_rel": 1, "cache_rel": 1},
                      per_layer=per_layer)
    out, _ = main.measure(cell, SimpleNamespace(seed=6, seconds=WINDOW_S, trace=1), cpu,
                          time.perf_counter())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    inside = m["layer_host_ms.prefill"] * cell.config["model"]["num_layers"] \
        + m["outside_layers_host_ms.prefill"]
    assert 0 < m["outside_layers_host_ms.prefill"] and 0 < inside <= m["dispatch_ms.prefill"]


def test_readers_on_a_small_train_run(cpu):
    per_layer = [{"name": f"{p}_host_ms.train", "unit": "ms"}
                 for p in ("forward", "backward", "optimizer")]
    cell = small_cell("tiny-ssm", "tiny-train", compute_dtype="float32",
                      limits={"loss_gap": 1, "grad_gap": 1, "change_gap": 1}, per_layer=per_layer)
    out, res = main.measure(cell, SimpleNamespace(seed=7, seconds=WINDOW_S, trace=1), cpu,
                            time.perf_counter())
    parts = [out["metrics"][m["name"]]["value"] for m in per_layer]
    untraced = [s for s, t in zip(res["window"].step_s, res["window"].traced) if not t]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= 1e3 * sum(untraced) / len(untraced)
