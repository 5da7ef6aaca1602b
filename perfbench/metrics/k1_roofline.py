"""K1's share of its roofline in the traced stretch: the least time the H100
could take for every K1 call (operations at the bf16 peak or bytes at HBM's
rate, from each call's shape: one call per layer and request) over the
device time of K1's kernels.  Nothing when no K1 kernel ran."""
from perfbench.harness.trace import is_k1
from perfbench.roofline import k1


def read(ctx):
    s = ctx.summary.time(is_k1)
    if not s:
        return None
    m = ctx.model
    calls = m["num_layers"] * len(ctx.traced)
    if ctx.launches.get("k1") != calls:
        raise RuntimeError(f"K1 launched {ctx.launches.get('k1')} times, {calls} expected")
    ideal = sum(m["num_layers"] * k1.bound_s(rows, m["num_heads"], m["num_kv_heads"], n,
                                              m["head_dim"]) for rows, n in ctx.traced)
    return 100 * ideal / s
