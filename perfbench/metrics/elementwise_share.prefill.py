"""The share of the traced stretch's device time spent outside K1, K2 and
the matmuls: the elementwise, reduction and copy work around the kernels."""
from perfbench.harness.trace import is_k1, is_k2, is_matmul


def read(ctx):
    total = ctx.summary.total()
    if not total:
        return None
    rest = ctx.summary.time(lambda n: not (is_k1(n) or is_k2(n) or is_matmul(n)))
    return 100 * rest / total
