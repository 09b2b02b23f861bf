"""mfu.train: the model's operations of the steps done inside the window
(forward and backward, no recomputation), counted as train_samples_per_s
counts samples, over the window's seconds, as a share of the card's bf16
peak."""

from kubebench.peaks import BF16_FLOPS


def read(ctx):
    if not ctx.steps:
        return None
    per_step = ctx.flops.step_flops(ctx.config, ctx.traffic)
    steps = len(ctx.steps) + sum(ctx.inside(a, b) for _, a, b in ctx.straddles)
    return steps * per_step / ctx.window_s / BF16_FLOPS * 100.0
