"""Causal grouped-query attention's forward: one hand-written CUDA kernel
for Hopper (``tpukube_torch/csrc/attention.cu``), and its plain PyTorch
version.

Source note. It replaces no TPU kernel: the JAX package's attention
(``tpukube/workload/llama.py``, ``_block``) is plain ``jnp``, an einsum, a
mask, a float32 softmax and a second einsum that XLA fuses. The port ran
the same chain op by op, and on the card it took 44% of Mistral-7B's
served forward and 23% of Moonlight-16B-A3B's: six passes and more over
a (B, KV, G, S, S) tensor (the products' layout copies, the scale, the
mask, the float32 copy, the softmax, the cast), where the products
themselves are a few microseconds a layer.

What bounds it: tensor-core operations from about S = 512 up, bytes
below. QK^T and PV under the causal mask are 2 * H * S(S+1)/2 * (dq + dv)
operations; q, k, v and the output are read and written once, linear in
S. What the design does about each:

- operations: the scores and probabilities never leave the chip. A block
  takes BLOCK_M = 128 query rows of one head, two consumer warpgroups of
  64 rows and one producer warp, and walks the key tiles of BLOCK_N = 64
  up to the diagonal only (flash-style online softmax), masking inside
  the diagonal tiles alone. Both products run on Hopper's ``wgmma``: the
  scores from q and k in shared memory, then the probabilities, still in
  registers, times v in shared memory, with float32 accumulators; a
  tile's scores go to the tensor cores while the last tile's PV product
  is still there, so its softmax runs beside that product. The grid is
  (query block, B * H), the longest rows first, so the last wave is
  short;
- bytes: q, k and v are read through their own strides in (B, S, heads,
  d) order by the Tensor Memory Accelerator, with no transpose, repeat
  or copy in front (Moonlight's v is a strided slice); query head h reads
  kv head h // (H // KV) in place; the producer keeps up to MAX_STAGES
  tiles of k and v in flight, as many as fit in a block's shared memory,
  so loads overlap the products; the output is written once as (B, S,
  H * dv). A ragged S is masked, not padded, in device memory; in shared
  memory a head dim is padded with zeros to whole 128-byte rows (dq 192
  stays 192), which adds nothing to a sum.

Block sizes come from (dq, dv) alone (:func:`plan`), and each pair is one
build (``nvcc`` at the first launch, into ``tpukube_torch/native/build``;
the source includes no PyTorch header, so a build takes seconds); S is a
runtime argument, so one build serves every prompt length, and nothing
synchronises or allocates: the kernel can be captured into a CUDA graph
once it has been built.

Rounding points follow the plain version where they cost nothing in
registers: the float32 QK^T is rounded to bf16, then scaled by dq^-1/2
and rounded again; the causal mask gives a probability of exactly zero;
the running max, the exponentials and the row sums are float32;
probabilities are rounded to bf16 before the PV product, which
accumulates in float32; the output is divided by the float32 row sum and
cast once. It departs in two ways: the probabilities it rounds are not
yet normalised (each relative to the running max, rescaled as the max
grows), and its float32 sums are taken in another order. The exponential
is 2**x of the scores times log2(e) (``ex2.approx``), in float32. Where
no row of a warp raised its max, the warp skips the rescale: its factors
are exactly 1.

:func:`causal_attention_fwd` takes the plain version for a CPU tensor
only; for a CUDA tensor it launches the kernel or raises. ``launches``
counts the kernel's launches. It has no backward: a caller that needs a
gradient runs :func:`causal_attention_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import torch

BLOCK_M = 128
BLOCK_N = 64
# the widest head dims the kernel takes: q.k up to four 128-byte rows, v's
# accumulators up to 64 registers a thread
MAX_DQ = 256
MAX_DV = 128
# the shared memory a block may take on the card (H100), and what the
# kernel's mbarriers take of it
BLOCK_SHARED_BYTES = 232_448
STATIC_SHARED_BYTES = 128
# tiles of k and v in flight
MAX_STAGES = 4
# the grid's second dimension, B * H
MAX_GRID_Y = 65_535

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "csrc", "attention.cu")
BUILD_DIR = os.path.join(_PACKAGE, "native", "build")

# kernel launches so far
launches = 0


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The explicit chain over q (B, S, H, dq), k (B, S, KV, dq) and v (B, S,
    KV, dv) -> (B, S, H * dv): query heads grouped over kv heads, QK^T
    scaled by dq^-1/2 in the inputs' dtype, masked with -1e9, softmax in
    float32, probabilities cast back before PV."""
    B, S, H, HD = q.shape
    KV, DV = k.shape[2], v.shape[-1]
    # GQA: group query heads (g) over kv heads (k)
    q = q.reshape(B, S, KV, H // KV, HD)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k) * (HD ** -0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H * DV)


def causal_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over q (B, S, H, dq), k (B, S, KV, dq) and v (B, S,
    KV, dv) -> (B, S, H * dv). A CPU tensor takes
    :func:`causal_attention_plain`; a CUDA tensor the kernel, which takes
    what :func:`check` allows and raises on anything else."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"causal attention runs on the CPU or a CUDA card, not {q.device}")
    check(q, k, v)
    return _forward(q, k, v)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError where the kernel does not take these arguments."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, d), not of shape {tuple(t.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, not {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    B, S, H, DQ = q.shape
    KV, DV = k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, S, KV, DQ) or tuple(v.shape[:3]) != (B, S, KV):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "do not share B, S, the kv heads and dq")
    if B * S == 0:
        raise ValueError(f"q holds no token: shape {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{KV} kv heads do not divide {H} query heads")
    for name, d, top in (("dq", DQ, MAX_DQ), ("dv", DV, MAX_DV)):
        if d % 8 or not 8 <= d <= top:
            raise ValueError(f"{name} must be a multiple of 8 from 8 to {top}, not {d}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} blocks a query block, past {MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel copies whole 16-byte pieces of a row
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must keep each head's d values contiguous and 16-byte "
                             f"aligned: strides {t.stride()}, address {t.data_ptr():#x}")


def _pad(d: int) -> int:
    """``d`` padded to whole 128-byte rows of bf16 (64 values)."""
    return -(-d // 64) * 64


@dataclass(frozen=True)
class Plan:
    """A build's geometry: head dims ``dq`` and ``dv``, ``block_m`` query
    rows by ``block_n`` keys a tile, and ``stages`` tiles of k and v in
    flight in shared memory."""

    dq: int
    dv: int
    block_m: int
    block_n: int
    stages: int

    @property
    def shared_bytes(self) -> int:
        """A block's shared memory: q's tile, the stages of k's and v's, and
        1,024 bytes to align them to the swizzle's 1,024-byte pattern."""
        dq, dv = _pad(self.dq), _pad(self.dv)
        return 2 * (self.block_m * dq + self.stages * self.block_n * (dq + dv)) + 1024

    def flags(self) -> list:
        """nvcc's flags for this build."""
        return ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a", "-shared",
                "-Xcompiler", "-fPIC", f"-DTK_DQ={self.dq}", f"-DTK_DV={self.dv}",
                f"-DTK_BM={self.block_m}", f"-DTK_BN={self.block_n}", f"-DTK_STAGES={self.stages}"]


@functools.cache
def plan(dq: int, dv: int) -> Plan:
    """The geometry for head dims (dq, dv): 128 query rows, 64 keys a tile,
    and as many stages as fit in a block's shared memory, up to
    MAX_STAGES."""
    one = Plan(dq, dv, BLOCK_M, BLOCK_N, 1)
    stage = one.shared_bytes - Plan(dq, dv, BLOCK_M, BLOCK_N, 0).shared_bytes
    room = BLOCK_SHARED_BYTES - STATIC_SHARED_BYTES - (one.shared_bytes - stage)
    return Plan(dq, dv, BLOCK_M, BLOCK_N, min(MAX_STAGES, room // stage))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


@functools.cache
def build(p: Plan) -> ctypes.CDLL:
    """The shared library of plan ``p``, built at its first use under a
    name that its source and flags fix, and loaded. A build goes in under a
    name of its own, then is renamed into place, so two processes that
    build at once do not collide."""
    flags = p.flags()
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"libattention_{p.dq}x{p.dv}_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, SOURCE], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {os.path.basename(path)}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.tk_attention_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                     + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p])
    lib.tk_attention_fwd.restype = ctypes.c_int
    lib.tk_attention_smem_bytes.restype = ctypes.c_int
    if lib.tk_attention_smem_bytes() != p.shared_bytes:
        raise RuntimeError(f"{path} takes {lib.tk_attention_smem_bytes()} bytes of shared "
                           f"memory a block, its plan {p.shared_bytes}")
    return lib


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    B, S, H, DQ = q.shape
    KV, DV = k.shape[2], v.shape[3]
    lib = build(plan(DQ, DV))
    out = torch.empty((B, S, H * DV), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = lib.tk_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, H // KV,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], out.stride(0), out.stride(1),
            DQ ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"causal_attention_fwd was not launched: CUDA error {err}")
    launches += 1
    return out
