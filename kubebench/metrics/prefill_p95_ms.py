"""prefill_p95_ms: the 95th percentile (nearest rank) over all requests
completed in the window, all pods together, each from its client's send
to its logits complete on the device (host clock)."""

from kubebench.traffic import percentile


def read(ctx):
    if not ctx.requests:
        return None
    return percentile([(r.done - r.sent) * 1e3 for r in ctx.requests], 95)
