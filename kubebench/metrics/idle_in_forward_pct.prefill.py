"""idle_in_forward_pct.prefill: of the profiled slice, the device's idle
stretches (the complement of the union of every pod's kernel intervals,
as idle_pct.prefill counts them, with no least length) that start while
a pod's host is inside a ``tpukube.forward`` span: the card waiting on
the forward's own launches. The spans are the program's (program span),
on the profiler's clock, from the one span file each pod left whose
spans fall inside its profiled slice; None where a pod has none or
several, or the program records no spans. ``split`` is shared with
idle_between_forwards_pct.prefill, which takes the rest of the idle time."""

import bisect

from kubebench import timeline

try:
    from tpukube_torch.obs.spans import files_for
except ImportError:  # a program that records no spans
    files_for = None

FORWARD = "tpukube.forward"


def split(ctx):
    """(idle in a forward, idle between forwards), each a % of the slice."""
    traces = [r.get("trace") for r in ctx.reports]
    if files_for is None or not traces or any(t is None for t in traces):
        return None
    found = files_for([(t["slice"][0] / 1e9, t["slice"][1] / 1e9) for t in traces])
    s0 = max(t["slice"][0] for t in traces)
    s1 = min(t["slice"][1] for t in traces)
    if found is None or s1 <= s0:
        return None
    forwards = timeline.merge([(s["t0"] * 1e9, s["t1"] * 1e9)
                               for spans in found for s in spans if s["name"] == FORWARD])
    if not forwards:
        return None
    busy = timeline.merge([(max(a, s0), min(b, s1)) for t in traces for a, b in t["busy"]
                           if min(b, s1) > max(a, s0)])
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    starts = [a for a, _ in forwards]
    inside = between = 0
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < forwards[i][1]:
            inside += b - a
        else:
            between += b - a
    return inside / (s1 - s0) * 100.0, between / (s1 - s0) * 100.0


def read(ctx):
    parts = split(ctx)
    return None if parts is None else parts[0]
