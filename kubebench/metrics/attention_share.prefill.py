"""attention_share.prefill: the sum of ``device_ms`` of the program's
``tpukube.attention`` spans (QK^T, scale, mask, f32 softmax, cast, PV of
one block) whose parent is a ``tpukube.forward`` span, over the sum of
``device_ms`` of those forwards, over the requests profiled (program
span). A span's ``device_ms`` is the device's wall time between two CUDA
events around it, idle time inside included. The spans come from the one
span file each pod left inside its profiled slice; None where a pod has
none or several, or the program records no spans."""

try:
    from tpukube_torch.obs.spans import files_for
except ImportError:  # a program that records no spans
    files_for = None


def read(ctx):
    traces = [r.get("trace") for r in ctx.reports]
    if files_for is None or not traces or any(t is None for t in traces):
        return None
    found = files_for([(t["slice"][0] / 1e9, t["slice"][1] / 1e9) for t in traces])
    if found is None:
        return None
    forward = attention = 0.0
    for spans in found:
        ids = {s["id"] for s in spans if s["name"] == "tpukube.forward"}
        forward += sum(s["device_ms"] for s in spans if s["id"] in ids)
        attention += sum(s["device_ms"] for s in spans
                         if s["name"] == "tpukube.attention" and s["parent"] in ids)
    return attention / forward * 100.0 if forward > 0 else None
