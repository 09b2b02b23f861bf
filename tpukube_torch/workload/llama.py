"""Llama-style decoder in PyTorch — the port of ``tpukube/workload/llama.py``.

The parameter tree is the reference's: the same keys, float32 leaves and
the layer-stacked leading ``L`` axis, so parameters carry across from JAX
as one ``torch.from_numpy`` per leaf (:func:`params_from_numpy`). Compute
is bfloat16 with the reference's rounding points:

- RMSNorm statistics in float32, cast back, then times the gain in bf16;
- RoPE angles in float32, cos/sin and the rotation in bf16, each head
  split in halves (not interleaved);
- GQA by grouping query heads over kv heads (query head h reads kv head
  h // (H // KV)), logits scaled in bf16, masked with -1e9, softmax in
  float32 and probabilities cast to bf16 before PV;
- float32 logits.

Attention is written as the explicit einsum/softmax of the reference, not
``F.scaled_dot_product_attention``, whose masking and rounding differ. The
projections are plain matrix products: XLA computes them outside any
kernel in the reference, and the JAX package has no hand kernel here.

``remat=True`` checkpoints each block (``torch.utils.checkpoint``, not
reentrant): the counterpart of the reference's ``jax.checkpoint``, the same
math with activations recomputed in the backward pass. :func:`_block` also
serves the tensor-parallel step of :mod:`tpukube_torch.workload.train`,
which hands it its local head counts and the collectives that enter and
leave each parallel region.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# The dtype activations are computed in: the reference's bfloat16. Every
# cast to the compute dtype reads it here, so the parity tests can run the
# same algorithm at float32 (in a process of their own) and hold it against
# the reference's at float32, below bf16's rounding noise.
COMPUTE_DTYPE = torch.bfloat16


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 256
    max_seq: int = 128
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B's published shape."""
        return LlamaConfig(
            vocab=128_256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14_336, max_seq=8192, rope_theta=500_000.0,
        )


def init_leaves(generator: torch.Generator, cfg: LlamaConfig,
                device: torch.device) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """The float32 leaves of :func:`init_params` as (path, tensor), in the
    order they draw from ``generator`` (which must live on ``device``), so
    that a sharded init can keep each shard and drop the rest of a leaf
    before the next one is drawn."""

    def dense(shape, fan_in):
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        ).mul_(fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    L, D, H, KV, HD, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)
    yield ("embed",), dense((cfg.vocab, D), D)
    yield ("layers", "attn_norm"), ones((L, D))
    yield ("layers", "wq"), dense((L, D, H * HD), D)
    yield ("layers", "wk"), dense((L, D, KV * HD), D)
    yield ("layers", "wv"), dense((L, D, KV * HD), D)
    yield ("layers", "wo"), dense((L, H * HD, D), H * HD)
    yield ("layers", "mlp_norm"), ones((L, D))
    yield ("layers", "w_gate"), dense((L, D, F_), D)
    yield ("layers", "w_up"), dense((L, D, F_), D)
    yield ("layers", "w_down"), dense((L, F_, D), F_)
    yield ("final_norm",), ones((D,))
    yield ("unembed",), dense((D, cfg.vocab), D)


def tree_leaves(tree: dict, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of a nested dict, keys sorted at every level: the
    order every rank walks a param tree, and so the order of per-leaf
    collectives."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += tree_leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def tree_from_leaves(leaves) -> dict:
    """Nest (path, value) pairs into the param tree."""
    tree: dict = {}
    for path, value in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: torch.device) -> dict:
    """float32 param tree, drawn from ``generator`` (which must live on
    ``device``). Same shapes and scales as the reference; the numbers
    differ, since torch cannot reproduce JAX's PRNG."""
    return tree_from_leaves(init_leaves(generator, cfg, device))


def params_from_numpy(tree: dict, device: torch.device) -> dict:
    """Copy a numpy param tree (e.g. the reference's params through
    ``np.asarray``) onto ``device``, leaf for leaf. The copies are the
    port's own, so training them in place leaves the arrays as they were."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    scale = torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * scale).to(x.dtype) * g.to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over (B, S, N, HD)."""
    _, S, _, HD = x.shape
    half = HD // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _block(h: torch.Tensor, layer: dict, cfg: LlamaConfig,
           heads: Optional[int] = None, kv_heads: Optional[int] = None,
           enter: Callable = _same, leave: Callable = _same) -> torch.Tensor:
    """One decoder block over activations (B, S, D) in the compute dtype.

    Tensor parallelism passes the rank's ``heads`` and ``kv_heads`` (the
    columns its ``wq``/``wk``/``wv`` shards hold) and the collectives that
    ``enter`` each parallel region (after the norm) and ``leave`` it (after
    the row-parallel product); the defaults are the whole model."""
    H = cfg.n_heads if heads is None else heads
    KV = cfg.n_kv_heads if kv_heads is None else kv_heads
    HD = cfg.head_dim

    x = enter(_rmsnorm(h, layer["attn_norm"], cfg.norm_eps))
    B, S, _ = x.shape
    q = x @ layer["wq"].to(x.dtype)
    k = x @ layer["wk"].to(x.dtype)
    v = x @ layer["wv"].to(x.dtype)
    q = _rope(q.reshape(B, S, H, HD), cfg.rope_theta)
    k = _rope(k.reshape(B, S, KV, HD), cfg.rope_theta)
    v = v.reshape(B, S, KV, HD)
    # GQA: group query heads (g) over kv heads (k)
    q = q.reshape(B, S, KV, H // KV, HD)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k) * (HD ** -0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    logits = logits.masked_fill(~causal, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H * HD)
    h = h + leave(ctx @ layer["wo"].to(x.dtype))

    x = enter(_rmsnorm(h, layer["mlp_norm"], cfg.norm_eps))
    gate = x @ layer["w_gate"].to(x.dtype)
    up = x @ layer["w_up"].to(x.dtype)
    return h + leave((F.silu(gate) * up) @ layer["w_down"].to(x.dtype))


def run_blocks(h: torch.Tensor, layers: dict, cfg: LlamaConfig,
               remat: bool = False, **tp) -> torch.Tensor:
    """The decoder stack: the reference's ``lax.scan`` over the stacked
    layer axis, each block checkpointed when ``remat``."""
    for i in range(layers["wq"].shape[0]):
        layer = {k: v[i] for k, v in layers.items()}
        if remat:
            h = checkpoint(_block, h, layer, cfg, use_reentrant=False, **tp)
        else:
            h = _block(h, layer, cfg, **tp)
    return h


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) float32."""
    # gather, then cast: the same values as the reference's cast-then-gather
    h = params["embed"][tokens].to(COMPUTE_DTYPE)
    h = run_blocks(h, params["layers"], cfg, remat)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return (h @ params["unembed"].to(h.dtype)).float()


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy (shifted), mean over all positions."""
    logits = forward(params, tokens[:, :-1], cfg, remat)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -torch.mean(ll)


class Llama(nn.Module):
    """The decoder as a module holding the param tree as trainable
    parameters. Serving runs it under ``torch.inference_mode()``."""

    def __init__(self, cfg: LlamaConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params["layers"].items()}
        )
        self.final_norm = nn.Parameter(params["final_norm"])
        self.unembed = nn.Parameter(params["unembed"])

    def param_tree(self) -> dict:
        """The param tree, in the reference's layout."""
        return {
            "embed": self.embed,
            "layers": dict(self.layers),
            "final_norm": self.final_norm,
            "unembed": self.unembed,
        }

    def forward(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        return forward(self.param_tree(), tokens, self.cfg, remat)

    def loss(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        return loss_fn(self.param_tree(), tokens, self.cfg, remat)
