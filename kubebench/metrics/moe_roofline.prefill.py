"""moe_roofline.prefill: the least time of the MoE layers' calls in the
requests profiled over their device time (program span): for each
``tpukube.moe`` span inside a ``tpukube.forward``, the larger of its
operations over the bf16 peak and its bytes over the bandwidth, from the
rows the span counted for each expert (``rows_per_expert``;
``flops/<family>.py``'s ``moe_bound_s``), summed, over the sum of the
spans' ``device_ms``. Taken over the whole call, so no fused or grouped
implementation can read past 100%. None where moe_share.prefill finds no
spans, or a span carries no counts."""

from kubebench.manifest import load_part

ROWS = "rows_per_expert"


def read(ctx):
    found = load_part("metrics", "moe_share.prefill").moe_spans(ctx)
    if found is None:
        return None
    _, moes = found
    if any(ROWS not in s.get("counts", {}) for s in moes):
        return None
    device_s = sum(s["device_ms"] for s in moes) / 1e3
    bound = sum(ctx.flops.moe_bound_s(ctx.config, s["counts"][ROWS]) for s in moes)
    return bound / device_s * 100.0 if device_s > 0 else None
