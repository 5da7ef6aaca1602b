"""K1's share of its roofline in the traced stretch of a cell whose layers
have windows (hymba-1.5b): the least time the H100 could take for every K1
call (`roofline/k1_window.py`: the pairs each layer's causal mask and window
keep, at the bf16 peak, or the bytes at HBM's rate) over the device time of
K1's kernels.  K1 must have launched once a layer and request, and, by the
port's step records (`flash_attention.window_launches`), once a windowed
layer and request with its window.  Nothing when no K1 kernel ran, or where
the step records carry no window counter (a program without it)."""
from perfbench.harness import spans
from perfbench.harness.trace import is_k1
from perfbench.roofline import k1_window

COUNTER = "flash_attention.window_launches"


def read(ctx):
    s = ctx.summary.time(is_k1)
    if not s:
        return None
    traced = [r for r, t in spans.records(ctx) or () if t]
    if not traced or any(COUNTER not in r.counters for r in traced):
        return None
    m = ctx.model
    windows = k1_window.windows(m)
    calls = len(windows) * len(ctx.traced)
    if ctx.launches.get("k1") != calls:
        raise RuntimeError(f"K1 launched {ctx.launches.get('k1')} times, {calls} expected")
    windowed = sum(w > 0 for w in windows)
    for r in traced:
        if r.counters[COUNTER] != windowed:
            raise RuntimeError(f"step record {r.id}: {r.counters[COUNTER]} K1 launches with a "
                               f"window, {windowed} expected")
    ideal = sum(k1_window.bound_s(rows, m["num_heads"], m["num_kv_heads"], n, m["head_dim"], w)
                for rows, n in ctx.traced for w in windows)
    return 100 * ideal / s
