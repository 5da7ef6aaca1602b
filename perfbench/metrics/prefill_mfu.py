"""The prefill's share of the H100's bf16 peak over the untraced requests of
the window: their model FLOPs (`roofline.model.prefill_flops`) over the sum
of their times from issue to first token."""
from perfbench.roofline import model, peaks


def read(ctx):
    if not ctx.untraced:
        return None
    flops = sum(model.prefill_flops(ctx.model, r, n) for r, n, _, _ in ctx.untraced)
    wall = sum(s for _, _, s, _ in ctx.untraced)
    return 100 * flops / wall / peaks.BF16_FLOPS
