"""The share of the traced steps' device time in PyTorch's elementwise and
concatenation kernels: the training scan's work."""
from perfbench.harness.trace import is_concat, is_elementwise


def read(ctx):
    total = ctx.summary.total()
    if not total:
        return None
    return 100 * ctx.summary.time(lambda n: is_elementwise(n) or is_concat(n)) / total
