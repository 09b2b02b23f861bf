"""share_skew_pct: |tokens of pod 0 - tokens of pod 1| / all tokens, of
the requests the two share pods completed in the window."""


def read(ctx):
    if len(ctx.reports) != 2 or not ctx.requests:
        return None
    per = [sum(r.length for r in ctx.requests if r.pod == k) for k in (0, 1)]
    return abs(per[0] - per[1]) / sum(per) * 100.0
