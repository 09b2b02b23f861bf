"""dense_roofline.prefill: the least time of the dense products
(projections, MLP, unembedding) of the requests profiled, each product's
larger of operations over the bf16 peak and bytes over the bandwidth,
over the device time of the same products: the kernels classed as matmul
or convolution in the profiled slice (device trace), less those that
attention's batched products (QK^T, PV) launched, which run as the same
GEMM kernels. A cell whose pods time-slice one card has no such time of
its own (a kernel's span there covers the other pod's slices), so the
manifest lists single-pod cells only."""

from kubebench.kinds import batched


def read(ctx):
    if ctx.trace is None or not ctx.trace.units:
        return None
    dense_s = sum(s for op, s in ctx.trace.dense_by_op.items() if not batched(op))
    if dense_s <= 0:
        return None
    bound = sum(ctx.flops.request_dense_bound_s(ctx.config, u["length"])
                for _, u in ctx.trace.units)
    return bound / dense_s * 100.0
