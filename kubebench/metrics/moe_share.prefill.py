"""moe_share.prefill: the sum of ``device_ms`` of the program's
``tpukube.moe`` spans (one MoE layer's router, dispatch, routed and shared
experts and combine) whose parent is a ``tpukube.forward`` span, over the
sum of ``device_ms`` of those forwards, over the requests profiled
(program span), as attention_share.prefill reads attention. None where a
pod has no span file or several in its slice, or the program records no
MoE spans."""

try:
    from tpukube_torch.obs.spans import files_for
except ImportError:  # a program that records no spans
    files_for = None

MOE = "tpukube.moe"


def moe_spans(ctx):
    """(the forwards' spans, their MoE children), each a list, all pods
    together; None where nothing can be read."""
    traces = [r.get("trace") for r in ctx.reports]
    if files_for is None or not traces or any(t is None for t in traces):
        return None
    found = files_for([(t["slice"][0] / 1e9, t["slice"][1] / 1e9) for t in traces])
    if found is None:
        return None
    forwards, moes = [], []
    for spans in found:
        ids = {s["id"] for s in spans if s["name"] == "tpukube.forward"}
        forwards += [s for s in spans if s["id"] in ids]
        moes += [s for s in spans if s["name"] == MOE and s["parent"] in ids]
    return (forwards, moes) if moes else None


def read(ctx):
    found = moe_spans(ctx)
    if found is None:
        return None
    forwards, moes = found
    forward = sum(s["device_ms"] for s in forwards)
    return sum(s["device_ms"] for s in moes) / forward * 100.0 if forward > 0 else None
