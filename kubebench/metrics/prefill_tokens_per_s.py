"""prefill_tokens_per_s: the prompt tokens processed inside the window,
all pods together, over the window's seconds (host clock): every request
completed in the window, and the share of the one each pod had in service
at the close that fell inside the window (its tokens times the share of
its service time before the close)."""


def read(ctx):
    if not ctx.requests:
        return None
    tokens = sum(r.length for r in ctx.requests)
    tokens += sum(n * ctx.inside(a, b) for n, a, b in ctx.straddles)
    return tokens / ctx.window_s
