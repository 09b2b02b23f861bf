"""idle_between_forwards_pct.prefill: the rest of the idle time that
idle_in_forward_pct.prefill splits: the idle stretches of the profiled
slice that start while no pod's host is inside a ``tpukube.forward``
span (the sync, the client loop, the next request's entry). The two sum
to idle_pct.prefill's reading of the same slice."""

from kubebench.manifest import load_part


def read(ctx):
    parts = load_part("metrics", "idle_in_forward_pct.prefill").split(ctx)
    return None if parts is None else parts[1]
