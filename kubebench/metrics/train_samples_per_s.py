"""train_samples_per_s: the samples trained on inside the window over the
window's seconds (host clock): every step completed in the window, and
the share of the step running at the close that fell inside it."""


def read(ctx):
    if not ctx.steps:
        return None
    samples = sum(s.samples for s in ctx.steps)
    samples += sum(n * ctx.inside(a, b) for n, a, b in ctx.straddles)
    return samples / ctx.window_s
