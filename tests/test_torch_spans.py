"""The port's spans and step records (`repro_torch.scope`): ranges only while
the profiler runs, the name stack left to `scope`, one record per step with
its host time by span, and the records' Unix clock against the profiler's."""
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import scope
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import api
from repro_torch.optim import adamw

PREFILL_SPANS = {
    "chatglm3-6b": {"prefill_step", "embed", "layer", "norm", "qkv", "attn", "mlp", "cache",
                    "final_norm", "logits"},
    "falcon-mamba-7b": {"prefill_step", "embed", "layer", "norm", "ssm", "conv", "ssm_params",
                        "scan", "out_proj", "cache", "final_norm", "logits"},
}


@pytest.fixture(autouse=True)
def recording():
    scope.record(True)
    yield
    scope.record(True)


def _model(arch, dtype=None):
    cfg = smoke_config(get_config(arch))
    if dtype:
        cfg = cfg.replace(compute_dtype=dtype)
    return cfg, api.init_params(cfg, 0, device="cpu")


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, {e.name() for e in prof.profiler.kineto_results.events()}


def test_scope_opens_no_range_with_the_profiler_off(monkeypatch):
    opened = []
    monkeypatch.setattr(scope, "record_function", lambda *a: opened.append(a))
    with scope.scope("outer"), scope.span("inner"):
        with scope.scope("mlp"):
            assert scope.current() == ("outer", "mlp")
    assert opened == [] and scope.current() == ()


def test_span_leaves_the_name_stack_alone():
    with scope.scope("layer"):
        with scope.span("norm"):
            assert scope.current() == ("layer",)
            with scope.scope("attn"):
                assert scope.current() == ("layer", "attn")
            with scope.span("qkv"), scope.span("rope"):
                assert scope.current() == ("layer",)
        assert scope.current() == ("layer",)
    assert scope.current() == ()


@pytest.mark.parametrize("arch", sorted(PREFILL_SPANS))
def test_every_scope_and_span_is_a_range_while_profiling(arch):
    cfg, p = _model(arch)
    batch = api.demo_batch(cfg, 2, 16, device="cpu")
    step = make_prefill_step(cfg, StepSettings(), cache_len=17)
    _, names = _profiled_names(lambda: step(p, batch))
    rec = scope.steps[-1]
    assert rec.profiled
    assert set(rec.spans) == PREFILL_SPANS[arch]
    assert PREFILL_SPANS[arch] <= names

    def outside_a_step():
        with scope.scope("outer"), scope.span("inner"):
            pass
    _, names = _profiled_names(outside_a_step)
    assert {"outer", "inner"} <= names


@pytest.mark.parametrize("arch", sorted(PREFILL_SPANS))
def test_prefill_makes_one_record_per_call(arch):
    """Ids increasing, kind, rows and length, num_layers `layer` spans, and self
    times that sum to the step's duration within 2%."""
    cfg, p = _model(arch)
    step = make_prefill_step(cfg, StepSettings(), cache_len=40)
    shapes = [(2, 24), (3, 32)]
    last = scope.steps[-1].id if scope.steps else 0
    for rows, length in shapes:
        step(p, api.demo_batch(cfg, rows, length, device="cpu"))
    recs = list(scope.steps)[-2:]
    assert last < recs[0].id < recs[1].id
    for rec, (rows, length) in zip(recs, shapes):
        assert (rec.kind, rec.rows, rec.length, rec.profiled) == ("prefill", rows, length, False)
        assert rec.spans["layer"][0] == cfg.num_layers
        assert rec.spans["prefill_step"] == (1, rec.end_ns - rec.start_ns,
                                             rec.spans["prefill_step"][2])
        duration = rec.end_ns - rec.start_ns
        assert abs(sum(s for _, _, s in rec.spans.values()) - duration) <= 0.02 * duration
        for count, inclusive, own in rec.spans.values():
            assert count >= 1 and 0 <= own <= inclusive <= duration
        assert rec.counters == {"flash_attention.launches": 0,
                                "flash_attention.window_launches": 0, "mamba_scan.launches": 0,
                                "mamba_scan.chunks": 0, "mamba_scan.backward_launches": 0}
        assert rec.unix_end_ns - rec.unix_start_ns == duration


def test_train_step_records_forward_and_backward_per_micro_batch():
    cfg, p = _model("falcon-mamba-7b", "float32")
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(cfg, opt_cfg, StepSettings(accum=2, remat="dots"))
    step(p, adamw.init(opt_cfg, p), api.demo_batch(cfg, 4, 16, device="cpu"))
    rec = scope.steps[-1]
    assert (rec.kind, rec.rows, rec.length) == ("train", 4, 16)
    assert rec.spans["forward"][0] == 2 and rec.spans["backward"][0] == 2
    assert rec.spans["optimizer"][0] == 1 and rec.spans["train_step"][0] == 1
    parts = sum(rec.spans[n][1] for n in ("forward", "backward", "optimizer"))
    assert parts <= rec.spans["train_step"][1]


def test_decode_step_records_the_positions_attended():
    cfg, p = _model("chatglm3-6b")
    batch = api.demo_batch(cfg, 2, 8, device="cpu")
    _, cache = make_prefill_step(cfg, StepSettings(), cache_len=12)(p, batch)
    make_decode_step(cfg)(p, cache, batch["tokens"][:, -1:], 8)
    rec = scope.steps[-1]
    assert (rec.kind, rec.rows, rec.length) == ("decode", 2, 9)
    assert rec.spans["layer"][0] == cfg.num_layers


def test_recording_off_records_nothing():
    cfg, p = _model("chatglm3-6b")
    step = make_prefill_step(cfg, StepSettings())
    last = scope.steps[-1].id if scope.steps else 0
    scope.record(False)
    step(p, api.demo_batch(cfg, 1, 8, device="cpu"))
    with scope.step("prefill", 1, 1) as rec:
        assert rec is None
    assert (scope.steps[-1].id if scope.steps else 0) == last
    scope.record(True)
    step(p, api.demo_batch(cfg, 1, 8, device="cpu"))
    assert scope.steps[-1].id > last


def test_the_log_keeps_the_last_steps():
    for i in range(scope.LOG_STEPS + 5):
        with scope.step("decode", 1, i):
            pass
    assert len(scope.steps) == scope.LOG_STEPS == scope.steps.maxlen
    assert [r.length for r in list(scope.steps)[-3:]] == [scope.LOG_STEPS + 2,
                                                         scope.LOG_STEPS + 3,
                                                         scope.LOG_STEPS + 4]
    ids = [r.id for r in scope.steps]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)


def test_counters_and_nesting_and_other_threads():
    """A record keeps its counters' change; a step inside a step is a span of
    the outer; a span on a thread with no open step is not counted."""
    box = {"launches": 3}
    seen = []

    def other():
        with scope.span("elsewhere"):
            seen.append(scope._local.__dict__.get("rec"))

    with scope.step("train", 2, 8, lambda: dict(box)) as rec:
        box["launches"] += 4
        with scope.step("prefill", 1, 1) as inner:
            assert inner is None
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert rec.counters == {"launches": 4}
    assert rec.spans["prefill_step"][0] == 1 and "elsewhere" not in rec.spans
    assert seen == [None] and scope.steps[-1] is rec


def test_record_lies_on_the_profilers_clock():
    """Under torch.profiler, a record's Unix start and end lie within 1 ms of the
    profiler's own `prefill_step` range."""
    cfg, p = _model("chatglm3-6b")
    step = make_prefill_step(cfg, StepSettings())
    batch = api.demo_batch(cfg, 2, 16, device="cpu")
    step(p, batch)
    prof, _ = _profiled_names(lambda: step(p, batch))
    rec = scope.steps[-1]
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "prefill_step"]
    assert len(ranges) == 1
    r = ranges[0]
    assert abs(rec.unix_start_ns - r.start_ns()) < 1e6
    assert abs(rec.unix_end_ns - (r.start_ns() + r.duration_ns())) < 1e6
    assert rec.profiled and rec.unix_start_ns >= r.start_ns()
