"""optimizer_share.train: the sum of ``device_ms`` of the program's
``tpukube.grad_norm`` (the clip's global norm) and ``tpukube.update``
(the clip's scale and AdamW; the ResNet's all-reduce and SGD) spans whose
parent is a ``tpukube.step`` span, over the sum of ``device_ms`` of those
steps, over the steps profiled (program span). A span's ``device_ms`` is
the device's wall time between two CUDA events around it. The spans come
from the one span file each pod left inside its profiled slice; None
where a pod has none or several, or the program records no spans."""

try:
    from tpukube_torch.obs.spans import files_for
except ImportError:  # a program that records no spans
    files_for = None

OPTIMIZER = ("tpukube.grad_norm", "tpukube.update")


def read(ctx):
    traces = [r.get("trace") for r in ctx.reports]
    if files_for is None or not traces or any(t is None for t in traces):
        return None
    found = files_for([(t["slice"][0] / 1e9, t["slice"][1] / 1e9) for t in traces])
    if found is None:
        return None
    step = optimizer = 0.0
    for spans in found:
        ids = {s["id"] for s in spans if s["name"] == "tpukube.step"}
        step += sum(s["device_ms"] for s in spans if s["id"] in ids)
        optimizer += sum(s["device_ms"] for s in spans
                         if s["name"] in OPTIMIZER and s["parent"] in ids)
    return optimizer / step * 100.0 if step > 0 else None
