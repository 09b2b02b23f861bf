"""idle_pct.train: The device's idle share of the profiled slice: 1 - the union of every
pod's kernel intervals / the slice's wall time (device trace)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
