"""Megatron's tensor-parallel collectives, as autograd functions over a
process group.

The reference gets these for free: GSPMD reads the PartitionSpecs of
``tpukube/workload/train.py`` (``param_specs``, the sequence-sharding
constraints of ``sp_forward``) and inserts each collective together with
its transpose in the backward pass. Here each forward collective is written
next to its conjugate:

=================  ============================  ==========================
function           forward                       backward
=================  ============================  ==========================
``copy_to_tp``     identity                      all-reduce
``reduce_from_tp`` all-reduce                    identity
``gather_seq``     all-gather on the sequence    reduce-scatter on it
``scatter_seq``    reduce-scatter on the seq.    all-gather on it
=================  ============================  ==========================

``torch.distributed.nn.functional.all_reduce`` is not ``reduce_from_tp``:
its backward all-reduces again, so a tp group of n would scale the
gradient by n.

Plus the two vocab-parallel ends of the model: :func:`vocab_parallel_embed`
(a masked lookup in the rank's rows of the table, then a reduce over tp)
and :func:`vocab_parallel_cross_entropy` (the max and the sum of exponents
all-reduced over tp, the target's logit taken from the rank that owns it).

Every collective runs whatever the group's size: a group of one still
launches it. Only the public ``torch.distributed`` calls are used
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``).
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.autograd import Function

ProcessGroup = dist.ProcessGroup


@contextmanager
def _renamed():
    # torch 2.13 deprecates all_gather_into_tensor and reduce_scatter_tensor
    # in favour of *_single names that torch 2.11 lacks; the calls are the same
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def all_reduce(x: torch.Tensor, group: ProcessGroup,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (``x`` is left as it is)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, dim: int, group: ProcessGroup) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    with _renamed():
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group: ProcessGroup) -> torch.Tensor:
    """Sum ``x`` over the ranks and keep this rank's part of ``dim``."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of size {xt.shape[0]} does not split over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    with _renamed():
        dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToTp(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromTp(Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, 1, ctx.group), None


class _ScatterSeq(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, 1, ctx.group), None


def copy_to_tp(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Enter a column-parallel region from a replicated input."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Leave a row-parallel region: sum the ranks' partial outputs."""
    return _ReduceFromTp.apply(x, group)


def gather_seq(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Enter a parallel region from a sequence-sharded (B, S/tp, ...) input."""
    return _GatherSeq.apply(x, group)


def scatter_seq(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Leave a row-parallel region into the sequence-sharded stream: sum
    the partial (B, S, ...) outputs and keep this rank's S/tp."""
    return _ScatterSeq.apply(x, group)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         vocab_start: int, group: ProcessGroup,
                         seq_parallel: bool, dtype: torch.dtype) -> torch.Tensor:
    """Look ``tokens`` (B, S) up in this rank's rows ``[vocab_start,
    vocab_start + len(table))`` of the embedding, cast to ``dtype``; other
    rows read zero. The ranks' lookups are summed: reduce-scattered onto
    the sequence shards under sequence parallelism (S must split over tp),
    all-reduced otherwise. One rank holds each token, so the sum is
    exact."""
    local = tokens - vocab_start
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    h = torch.where(hit[..., None], rows, 0.0).to(dtype)
    return scatter_seq(h, group) if seq_parallel else reduce_from_tp(h, group)


class _VocabParallelCE(Function):
    @staticmethod
    def forward(ctx, logits, targets, vocab_start, group):
        # logits (N, V/tp) float32: this rank's columns of the vocabulary
        local = targets - vocab_start
        hit = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        top = all_reduce(logits.max(dim=-1).values, group, dist.ReduceOp.MAX)
        shifted = logits - top[:, None]
        target = torch.where(hit, shifted.gather(-1, local[:, None])[:, 0], 0.0)
        target = all_reduce(target, group)
        exp = shifted.exp_()
        sumexp = all_reduce(exp.sum(dim=-1), group)
        ctx.save_for_backward(exp.div_(sumexp[:, None]), local, hit)
        return sumexp.log() - target

    @staticmethod
    def backward(ctx, grad):
        # d nll / d logits = softmax - onehot(target), on this rank's columns
        softmax, local, hit = ctx.saved_tensors
        out = softmax.clone()
        out.scatter_add_(-1, local[:, None], -hit[:, None].to(out.dtype))
        return out.mul_(grad[:, None]), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 vocab_start: int,
                                 group: ProcessGroup) -> torch.Tensor:
    """Per-position negative log-likelihood (N,) of ``targets`` (N,) under
    the softmax over the whole vocabulary, from this rank's float32 logit
    columns (N, V/tp) starting at ``vocab_start``. Every rank of ``group``
    gets the same values; the backward gives each rank the gradient of its
    own columns and needs no collective."""
    return _VocabParallelCE.apply(logits, targets, vocab_start, group)
