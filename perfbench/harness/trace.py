"""The traced stretch: torch.profiler over a fixed number of requests or
steps, read from the profiler's raw events (not its event tree, which takes
tens of seconds to build for a train step of ~10^5 ops).

The stretch is one `record_function` range; its span on the host's timeline
is the traced window.  Device activity is every kernel, copy and fill on the
card inside it; busy time is the union of their intervals.  An idle gap is
labelled by the innermost host operation open when the gap began."""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

MARK = "perfbench.traced_window"
MATMUL = ("gemm", "nvjet", "cutlass", "xmma", "gemv", "gemmk", "cublas")


def is_k1(name):
    return "flash_fwd" in name


def is_k2(name):
    return "mamba_scan" in name


def is_matmul(name):
    low = name.lower()
    return any(k in low for k in MATMUL)


def is_elementwise(name):
    return "elementwise" in name.lower()


def is_concat(name):
    return "CatArrayBatchedCopy" in name


class Summary:
    """What the readers read: each device operation's (name, seconds) inside
    the window, the window's length and the device's busy seconds in it."""

    def __init__(self, ops, window_s, busy_s, gaps):
        self.ops, self.window_s, self.busy_s, self.gaps = ops, window_s, busy_s, gaps

    def time(self, pred):
        return sum(s for name, s in self.ops if pred(name))

    def total(self):
        return sum(s for _, s in self.ops)

    def breakdown(self, top=10):
        by_name = defaultdict(float)
        for name, s in self.ops:
            by_name[name[:120]] += s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def traced(out):
    """Profile the block; put its Summary in out["summary"]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(MARK):
            yield
            sync()
    window, device, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, start + dur, e.name()))
        elif e.name() == MARK:
            window = (start, start + dur)
        else:
            host.append((start, start + dur, e.name()))
    if window is None:
        raise RuntimeError("the profiler's events hold no traced window")
    out["summary"] = summarise(window, device, host)


def summarise(window, device, host):
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    ops = [(n, (e - s) / 1e9) for s, e, n in device]
    busy, gaps, cursor = 0, [], w0
    for s, e, _ in device:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    host = sorted(host)
    starts = [h[0] for h in host]
    labelled = defaultdict(float)
    for g0, g1 in gaps:
        labelled[_host_at(host, starts, g0)] += (g1 - g0) / 1e9
    return Summary(ops, (w1 - w0) / 1e9, busy / 1e9, dict(labelled))


def _host_at(host, starts, t, reach=64):
    """The innermost host operation open at t: of those that started last, the
    first that has not ended; "no host op" if none within `reach`."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if host[j][1] >= t:
            return host[j][2][:80]
    return "no host op"
