"""GroupNorm over a ``channels_last`` activation, with the ReLU after it
fused: a hand-written Triton kernel pair, forward and backward, and its
plain PyTorch version.

Source note. It replaces no TPU kernel: the JAX package's GroupNorm
(``tpukube/workload/resnet.py``, ``_group_norm``) is plain ``jnp``. It was
added because on the card the plain version, ``F.group_norm`` on a float32
copy with a cast back and the ReLU as passes of their own, spent most of
the ResNet step on copies: a float32 copy of each activation and a
relayout to NCHW and back, forward and backward, for each of ResNet-50's
49 norms.

What bounds it: bytes. It does a few operations an element, far below
the ~295 a byte at which the card's compute would bind. The forward reads
the activation twice (statistics, then the normalised output) and writes
it once: 6 B an element in bf16. The backward reads the activation and
the incoming gradient twice (per-channel sums, then the input's gradient)
and writes once: 10 B. What the design does about it:

- it reads and writes the activation's own bytes, bf16 NHWC, with no
  copy, relayout or float32 intermediate in device memory; the ReLU's
  mask in the backward is recomputed from the input and the statistics,
  not stored;
- a tile is (rows of H*W, a block of whole groups' channels), each row
  contiguous channels, so loads and stores are coalesced along C whether
  a group is 2 channels wide or 64;
- the grid is (sample, split of H*W, channel block): enough programs to
  fill the card at each of ResNet-50's shapes. Each program loops over its
  split and leaves partials (each group's mean and sum of squared
  deviations; in the backward, each channel's sums), which the second
  kernel of the pair merges in a fixed order before its own pass. Inside
  the loop each thread updates its own slots of the tile (Welford's
  update; plain sums in the backward), and the slots are reduced across
  threads once, after it. No atomics: a run repeats bit for bit.

Rounding points follow the reference (``tpukube/workload/resnet.py``):
float32 mean and variance as ``mean((x - mean)**2)`` (Welford's update
and Chan et al.'s merge of partials, never ``E[x**2] - mean**2``), then
``(x - mean) * rsqrt(var + eps)``, then ``* scale + bias`` in float32, one
cast to the input's dtype, then the ReLU (taken before the cast, which
gives the same values). The backward computes in
float32 from the cast gradient, casts the input's gradient once, and
keeps the scale's and bias's gradients in float32.

:func:`group_norm` takes the plain version for a CPU tensor only; for a
CUDA tensor it launches the kernels or raises. ``GroupNormNHWC.launches``
counts the kernels launched (two a direction).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace

import torch
import torch.nn.functional as F

# A tile's elements; the programs a launch aims at (132 SMs, several
# resident on each); the most splits of H*W, which bounds each merge.
TILE = 4096
PROGRAMS = 1024
MAX_SPLITS = 32
NUM_WARPS = 4
# The widest block of channels a program takes.
MAX_BLOCK_C = 256


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """The plain version: float32 GroupNorm of ``x`` with ``scale`` and
    ``bias``, cast back to ``x``'s dtype, then the ReLU if ``relu``."""
    y = F.group_norm(x.float(), groups, scale, bias, eps).to(x.dtype)
    return F.relu(y) if relu else y


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """GroupNorm of the (N, C, H, W) activation ``x`` over ``groups`` groups
    of contiguous channels, with float32 ``scale`` and ``bias`` of (C,), and
    the ReLU after it if ``relu``. A CPU tensor takes
    :func:`group_norm_plain`; a CUDA tensor the kernels, which take bfloat16
    or float32 in ``channels_last`` memory and raise on anything else."""
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on the CPU or a CUDA card, not {x.device}")
    return GroupNormNHWC.apply(x, scale, bias, groups, eps, relu)


def check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    """Raise ValueError where the kernels do not take these arguments."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), not of shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last-contiguous (NHWC bytes)")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{groups} groups do not divide {c} channels")
    width = c // groups
    if width & (width - 1):
        raise ValueError(f"a group's width must be a power of two, not {width}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) on {x.device}")


@dataclass(frozen=True)
class Plan:
    """A launch's geometry: each program takes ``groups_per_block`` whole
    groups of ``group_width`` channels and ``rows`` rows of H*W (one
    split), ``block_rows`` rows a tile."""

    group_width: int
    groups_per_block: int
    block_rows: int
    rows: int
    splits: int

    @property
    def block_c(self) -> int:
        return self.group_width * self.groups_per_block


def plan(n: int, c: int, hw: int, groups: int) -> Plan:
    """The geometry for ``n`` samples of ``hw`` positions by ``c`` channels
    in ``groups`` groups: the most whole groups up to ``MAX_BLOCK_C``
    channels a block, ``TILE`` elements a tile, and H*W split so that the
    grid holds about ``PROGRAMS`` programs, each split a whole number of
    tiles."""
    width = c // groups
    gpb = 1
    while groups % (2 * gpb) == 0 and 2 * gpb * width <= MAX_BLOCK_C:
        gpb *= 2
    block_rows = max(1, TILE // (width * gpb))
    tiles = -(-hw // block_rows)
    blocks = n * (groups // gpb)
    splits = max(1, min(tiles, MAX_SPLITS, -(-PROGRAMS // blocks)))
    rows = -(-tiles // splits) * block_rows
    return Plan(width, gpb, block_rows, rows, -(-hw // rows))


class GroupNormNHWC(torch.autograd.Function):
    """The kernel pair under autograd. It saves the input and the float32
    mean and rstd of (N, G), and recomputes the ReLU's mask from them."""

    launches = 0

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        check(x, scale, bias, groups)
        y, mean, rstd = _forward(x, scale, bias, groups, eps, relu)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.groups, ctx.relu = groups, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = _backward(dy, x, scale, bias, mean, rstd, ctx.groups, ctx.relu)
        return dx, dscale, dbias, None, None, None


def _forward(x, scale, bias, groups, eps, relu):
    k = _kernels()
    n, c, h, w = x.shape
    p = plan(n, c, h * w, groups)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((2, n, p.splits, groups), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, n, groups), device=x.device, dtype=torch.float32)
    grid = (n, p.splits, c // p.block_c)
    meta = dict(CG=p.group_width, GPB=p.groups_per_block, BLOCK_HW=p.block_rows,
                num_warps=NUM_WARPS)
    with torch.cuda.device(x.device):
        k.stats[grid](x, part[0], part[1], h * w, c, groups, p.rows, **meta)
        k.apply[grid](x, y, scale, bias, part[0], part[1], stats[0], stats[1],
                      h * w, c, groups, p.rows, p.splits, eps, RELU=relu, **meta)
    GroupNormNHWC.launches += 2
    return y, stats[0], stats[1]


def _backward(dy, x, scale, bias, mean, rstd, groups, relu):
    k = _kernels()
    n, c, h, w = x.shape
    p = plan(n, c, h * w, groups)
    # the gradient arrives in whatever layout autograd made (the pool's
    # backward expands it); the kernels read NHWC
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((2, n, p.splits, c), device=x.device, dtype=torch.float32)
    dparams = torch.empty((2, c), device=x.device, dtype=torch.float32)
    blocks = c // p.block_c
    meta = dict(CG=p.group_width, GPB=p.groups_per_block, BLOCK_HW=p.block_rows, RELU=relu,
                num_warps=NUM_WARPS)
    with torch.cuda.device(x.device):
        k.grad_reduce[(n, p.splits, blocks)](
            x, dy, scale, bias, mean, rstd, part[0], part[1], h * w, c, groups, p.rows, **meta)
        k.grad_apply[(n + 1, p.splits, blocks)](
            x, dy, dx, scale, bias, mean, rstd, part[0], part[1], dparams[0], dparams[1],
            n, h * w, c, groups, p.rows, p.splits, BLOCK_P=max(1, TILE // p.block_c), **meta)
    GroupNormNHWC.launches += 2
    return dx, dparams[0], dparams[1]


@functools.cache
def _kernels() -> SimpleNamespace:
    """Build the four kernels (at the first launch: the module itself
    imports no ``triton``). Offsets within a sample are int32; a sample's
    base is int64."""
    import triton
    import triton.language as tl

    @triton.jit
    def group_norm_stats(x_ptr, pmean_ptr, pm2_ptr, HW, C, G, ROWS,
                         CG: tl.constexpr, GPB: tl.constexpr, BLOCK_HW: tl.constexpr):
        # One split's statistics of GPB groups: Welford's update in each
        # slot of the tile, then the slots merged into each group's mean and
        # sum of squared deviations (Chan et al.). The loop does no
        # reduction across threads.
        BLOCK_C: tl.constexpr = CG * GPB
        n = tl.program_id(0)
        s = tl.program_id(1)
        cb = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        rows = tl.arange(0, BLOCK_HW)
        x_ptr += n.to(tl.int64) * HW * C
        start = s * ROWS
        end = tl.minimum(start + ROWS, HW)
        cnt = tl.zeros([BLOCK_HW], tl.float32)
        mean = tl.zeros([BLOCK_HW, BLOCK_C], tl.float32)
        m2 = tl.zeros([BLOCK_HW, BLOCK_C], tl.float32)
        for r0 in range(start, end, BLOCK_HW):
            r = r0 + rows
            inside = r < end
            x = tl.load(x_ptr + r[:, None] * C + cols[None, :], mask=inside[:, None],
                        other=0.0).to(tl.float32)
            cnt += inside.to(tl.float32)
            d = x - mean
            mean += d * tl.where(inside, 1.0 / cnt, 0.0)[:, None]
            m2 += tl.where(inside[:, None], d * (x - mean), 0.0)
        total = tl.sum(cnt, axis=0) * CG
        g_mean = tl.sum(tl.reshape(tl.sum(mean * cnt[:, None], axis=0), (GPB, CG)), axis=1) / total
        d = mean - tl.reshape(tl.broadcast_to(g_mean[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
        g_m2 = tl.sum(tl.reshape(tl.sum(m2 + cnt[:, None] * d * d, axis=0), (GPB, CG)), axis=1)
        out = (n * tl.num_programs(1) + s) * G + cb * GPB + tl.arange(0, GPB)
        tl.store(pmean_ptr + out, g_mean)
        tl.store(pm2_ptr + out, g_m2)

    @triton.jit
    def group_norm_apply(x_ptr, y_ptr, scale_ptr, bias_ptr, pmean_ptr, pm2_ptr, mean_ptr,
                         rstd_ptr, HW, C, G, ROWS, S, eps,
                         CG: tl.constexpr, GPB: tl.constexpr, BLOCK_HW: tl.constexpr,
                         RELU: tl.constexpr):
        # Merge the splits' partials in split order, then normalise the split.
        BLOCK_C: tl.constexpr = CG * GPB
        n = tl.program_id(0)
        s = tl.program_id(1)
        cb = tl.program_id(2)
        g = cb * GPB + tl.arange(0, GPB)
        total = HW * CG * 1.0
        acc = tl.zeros([GPB], tl.float32)
        for i in range(0, S):
            k = tl.minimum(HW - i * ROWS, ROWS) * CG * 1.0
            acc += k * tl.load(pmean_ptr + (n * S + i) * G + g)
        mean = acc / total
        acc = tl.zeros([GPB], tl.float32)
        for i in range(0, S):
            k = tl.minimum(HW - i * ROWS, ROWS) * CG * 1.0
            d = tl.load(pmean_ptr + (n * S + i) * G + g) - mean
            acc += tl.load(pm2_ptr + (n * S + i) * G + g) + k * d * d
        rstd = 1.0 / tl.sqrt(acc / total + eps)
        if s == 0:
            tl.store(mean_ptr + n * G + g, mean)
            tl.store(rstd_ptr + n * G + g, rstd)
        mean_c = tl.reshape(tl.broadcast_to(mean[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
        rstd_c = tl.reshape(tl.broadcast_to(rstd[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        scale = tl.load(scale_ptr + cols)[None, :]
        bias = tl.load(bias_ptr + cols)[None, :]
        base = n.to(tl.int64) * HW * C
        rows = tl.arange(0, BLOCK_HW)
        start = s * ROWS
        end = tl.minimum(start + ROWS, HW)
        for r0 in range(start, end, BLOCK_HW):
            r = r0 + rows
            inside = (r < end)[:, None]
            off = base + r[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + off, mask=inside, other=0.0).to(tl.float32)
            y = (x - mean_c) * rstd_c * scale + bias
            if RELU:
                y = tl.where(y < 0, 0.0, y)
            tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=inside)

    @triton.jit
    def group_norm_grad_reduce(x_ptr, dy_ptr, scale_ptr, bias_ptr, mean_ptr, rstd_ptr,
                               pa_ptr, pb_ptr, HW, C, G, ROWS,
                               CG: tl.constexpr, GPB: tl.constexpr, BLOCK_HW: tl.constexpr,
                               RELU: tl.constexpr):
        # One split's per-channel sums of the gradient g (after the ReLU's
        # mask) and of g * xhat, kept slot by slot and reduced once at the end.
        BLOCK_C: tl.constexpr = CG * GPB
        n = tl.program_id(0)
        s = tl.program_id(1)
        cb = tl.program_id(2)
        g = cb * GPB + tl.arange(0, GPB)
        mean = tl.load(mean_ptr + n * G + g)
        rstd = tl.load(rstd_ptr + n * G + g)
        mean_c = tl.reshape(tl.broadcast_to(mean[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
        rstd_c = tl.reshape(tl.broadcast_to(rstd[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        scale = tl.load(scale_ptr + cols)[None, :]
        bias = tl.load(bias_ptr + cols)[None, :]
        base = n.to(tl.int64) * HW * C
        rows = tl.arange(0, BLOCK_HW)
        start = s * ROWS
        end = tl.minimum(start + ROWS, HW)
        a = tl.zeros([BLOCK_HW, BLOCK_C], tl.float32)
        b = tl.zeros([BLOCK_HW, BLOCK_C], tl.float32)
        for r0 in range(start, end, BLOCK_HW):
            r = r0 + rows
            inside = (r < end)[:, None]
            off = base + r[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + off, mask=inside, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=inside, other=0.0).to(tl.float32)
            xhat = (x - mean_c) * rstd_c
            if RELU:
                y = (xhat * scale + bias).to(x_ptr.dtype.element_ty)
                dy = tl.where(y > 0, dy, 0.0)
            a += dy
            b += dy * xhat
        out = (n * tl.num_programs(1) + s) * C + cols
        tl.store(pa_ptr + out, tl.sum(a, axis=0))
        tl.store(pb_ptr + out, tl.sum(b, axis=0))

    @triton.jit
    def group_norm_grad_apply(x_ptr, dy_ptr, dx_ptr, scale_ptr, bias_ptr, mean_ptr, rstd_ptr,
                              pa_ptr, pb_ptr, dscale_ptr, dbias_ptr, N, HW, C, G, ROWS, S,
                              CG: tl.constexpr, GPB: tl.constexpr, BLOCK_HW: tl.constexpr,
                              BLOCK_P: tl.constexpr, RELU: tl.constexpr):
        # Programs n < N: the input's gradient of one split. The row n == N:
        # the scale's and bias's gradients, every partial summed in order.
        BLOCK_C: tl.constexpr = CG * GPB
        n = tl.program_id(0)
        s = tl.program_id(1)
        cb = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        if n == N:
            if s == 0:
                prow = tl.arange(0, BLOCK_P)
                a = tl.zeros([BLOCK_C], tl.float32)
                b = tl.zeros([BLOCK_C], tl.float32)
                for q0 in range(0, N * S, BLOCK_P):
                    q = q0 + prow
                    off = q[:, None] * C + cols[None, :]
                    used = (q < N * S)[:, None]
                    a += tl.sum(tl.load(pa_ptr + off, mask=used, other=0.0), axis=0)
                    b += tl.sum(tl.load(pb_ptr + off, mask=used, other=0.0), axis=0)
                tl.store(dbias_ptr + cols, a)
                tl.store(dscale_ptr + cols, b)
        else:
            a = tl.zeros([BLOCK_C], tl.float32)
            b = tl.zeros([BLOCK_C], tl.float32)
            for i in range(0, S):
                a += tl.load(pa_ptr + (n * S + i) * C + cols)
                b += tl.load(pb_ptr + (n * S + i) * C + cols)
            scale = tl.load(scale_ptr + cols)
            inv = 1.0 / (HW * CG * 1.0)
            c1 = tl.sum(tl.reshape(a * scale, (GPB, CG)), axis=1) * inv
            c2 = tl.sum(tl.reshape(b * scale, (GPB, CG)), axis=1) * inv
            c1 = tl.reshape(tl.broadcast_to(c1[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
            c2 = tl.reshape(tl.broadcast_to(c2[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
            g = cb * GPB + tl.arange(0, GPB)
            mean = tl.load(mean_ptr + n * G + g)
            rstd = tl.load(rstd_ptr + n * G + g)
            mean_c = tl.reshape(tl.broadcast_to(mean[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
            rstd_c = tl.reshape(tl.broadcast_to(rstd[:, None], (GPB, CG)), (BLOCK_C,))[None, :]
            scale = scale[None, :]
            bias = tl.load(bias_ptr + cols)[None, :]
            base = n.to(tl.int64) * HW * C
            rows = tl.arange(0, BLOCK_HW)
            start = s * ROWS
            end = tl.minimum(start + ROWS, HW)
            for r0 in range(start, end, BLOCK_HW):
                r = r0 + rows
                inside = (r < end)[:, None]
                off = base + r[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + off, mask=inside, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + off, mask=inside, other=0.0).to(tl.float32)
                xhat = (x - mean_c) * rstd_c
                if RELU:
                    y = (xhat * scale + bias).to(x_ptr.dtype.element_ty)
                    dy = tl.where(y > 0, dy, 0.0)
                dx = rstd_c * (dy * scale - c1 - xhat * c2)
                tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=inside)

    return SimpleNamespace(stats=group_norm_stats, apply=group_norm_apply,
                           grad_reduce=group_norm_grad_reduce, grad_apply=group_norm_grad_apply)
