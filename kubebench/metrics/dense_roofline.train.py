"""dense_roofline.train: the least time of the dense products of the
steps profiled (projections, MLP, unembedding; convolutions and the
head), forward and backward without recomputation, over the device time
of the same products: the kernels classed as matmul or convolution in the
profiled slice (device trace), less those that attention's batched
products (QK^T, PV, and their gradients) launched. A recomputed forward's
products are in the time and not in the count: the model needs them
once."""

from kubebench.kinds import batched


def read(ctx):
    if ctx.trace is None or not ctx.trace.units:
        return None
    dense_s = sum(s for op, s in ctx.trace.dense_by_op.items() if not batched(op))
    if dense_s <= 0:
        return None
    bound = len(ctx.trace.units) * ctx.flops.step_dense_bound_s(ctx.config, ctx.traffic)
    return bound / dense_s * 100.0
