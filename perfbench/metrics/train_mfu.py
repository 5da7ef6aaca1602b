"""The train step's share of the H100's bf16 peak over the untraced steps of
the window: 6·N·tokens (`roofline.model.train_flops`) over their summed time."""
from perfbench.roofline import model, peaks


def read(ctx):
    if not ctx.untraced:
        return None
    rows, seq = ctx.traffic["rows"], ctx.traffic["seq"]
    flops = model.train_flops(ctx.model, rows, seq) * len(ctx.untraced)
    return 100 * flops / sum(ctx.untraced) / peaks.BF16_FLOPS
