"""The fused K2's share of its roofline in the traced stretch: the least time
for every call (bytes at HBM's rate, or operations at the float32 peak, from
each call's shape: one call per layer and request, x in bf16) over the device
time of K2's kernels.  Nothing when no K2 kernel ran."""
from perfbench.harness.trace import is_k2
from perfbench.roofline import k2


def read(ctx):
    s = ctx.summary.time(is_k2)
    if not s:
        return None
    m = ctx.model
    calls = m["num_layers"] * len(ctx.traced)
    if ctx.launches.get("k2") != calls:
        raise RuntimeError(f"K2 launched {ctx.launches.get('k2')} times, {calls} expected")
    di = m["expand"] * m["d_model"]
    ideal = sum(m["num_layers"] * k2.bound_s(rows, n, di, m["ssm_state"])
                for rows, n in ctx.traced)
    return 100 * ideal / s
