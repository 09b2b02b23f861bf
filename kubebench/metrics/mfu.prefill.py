"""mfu.prefill: the model's operations (the benchmark's count, causal
attention over its triangle) done inside the window, counted as
prefill_tokens_per_s counts tokens, over the window's seconds, as a share
of the card's bf16 peak."""

from kubebench.peaks import BF16_FLOPS


def read(ctx):
    if not ctx.requests:
        return None
    flops = sum(ctx.flops.request_flops(ctx.config, r.length) for r in ctx.requests)
    flops += sum(ctx.flops.request_flops(ctx.config, n) * ctx.inside(a, b)
                 for n, a, b in ctx.straddles)
    return flops / ctx.window_s / BF16_FLOPS * 100.0
