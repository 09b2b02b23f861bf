"""Plain PyTorch reference of the decoder: Mistral-7B-v0.3's layer
equations (``configs/mistral-7b*.json``), written from the published
description and not from the program.

Per block: RMSNorm (x / sqrt(mean(x^2) + eps) * g), Q/K/V projections,
rotary embedding over each head split in halves (non-interleaved, angles
pos * theta^(-2i/head_dim)), grouped-query attention (query head h reads
kv head h // (H / KV)) with a causal softmax scaled by head_dim^-1/2, the
output projection and a residual add; then RMSNorm, SwiGLU (down(silu(gate)
* up)) and a residual add. A final RMSNorm and the untied unembedding give
the logits. No biases, no sliding window.

Everything is float32 with TF32 off (:func:`precise`). ``precision="fp8"``
is the control: every product's operands rounded to float8 e4m3 (scaled
per tensor), their gradients to e5m2, the products summed in float32.

Parameters come in the port's layout (layer-stacked leaves; see
``kubebench.weights``), made by the benchmark from the seed; nothing of the
program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def precise() -> None:
    """float32 products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in x's
    dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float().div_(scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def _mm(a, b, precision):
    return operand(a, precision) @ operand(b, precision)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rotary(x, theta):
    """x (S, N, HD) rotated by position."""
    S, _, HD = x.shape
    half = HD // 2
    inv = theta ** (-torch.arange(0, HD, 2, device=x.device, dtype=torch.float32) / HD)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(h, layer: dict, cfg: dict, precision: str = "fp32"):
    """One decoder layer over h (S, D) float32."""
    D, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    HD, eps = D // H, cfg["rms_norm_eps"]
    S = h.shape[0]
    x = rms_norm(h, layer["attn_norm"], eps)
    q = rotary(_mm(x, layer["wq"], precision).view(S, H, HD), cfg["rope_theta"])
    k = rotary(_mm(x, layer["wk"], precision).view(S, KV, HD), cfg["rope_theta"])
    v = _mm(x, layer["wv"], precision).view(S, KV, HD)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), precision) / math.sqrt(HD)
    future = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = _mm(probs, v.transpose(0, 1), precision).transpose(0, 1).reshape(S, H * HD)
    h = h + _mm(ctx, layer["wo"], precision)
    x = rms_norm(h, layer["mlp_norm"], eps)
    act = F.silu(_mm(x, layer["w_gate"], precision)) * _mm(x, layer["w_up"], precision)
    return h + _mm(act, layer["w_down"], precision)


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def logits(params: dict, tokens: torch.Tensor, cfg: dict, precision: str = "fp32",
           remat: bool = False) -> torch.Tensor:
    """tokens (S,) -> logits (S, vocab) float32."""
    h = params["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        if remat:
            h = checkpoint(block, h, _layer(params, i), cfg, precision, use_reentrant=False)
        else:
            h = block(h, _layer(params, i), cfg, precision)
    h = rms_norm(h, params["final_norm"], cfg["rms_norm_eps"])
    return _mm(h, params["unembed"], precision)


@torch.no_grad()
def served_gap(params: dict, tokens: torch.Tensor, served: torch.Tensor,
               cfg: dict) -> float:
    """The widest gap, over the positions of one prompt, by which the
    served next token's reference logit lies below the reference's best."""
    out = logits(params, tokens, cfg)
    gap = out.max(-1).values - out.gather(-1, served.long()[:, None])[:, 0]
    return float(gap.max())


@torch.no_grad()
def greedy(params: dict, tokens: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """The token the reference at ``precision`` puts first at each
    position (the control's served tokens)."""
    return logits(params, tokens, cfg, precision).argmax(-1)


# ------------------------------------------------------------- training
def _nll_sum(params, rows, cfg, precision):
    # float32 keeps every block's activations: a row's, at S=4,096 over 8
    # layers, fit the card, and recomputing blocks costs more than twice
    # the time. The control's rounded copies of the S x S operands would
    # not fit, so it recomputes each block.
    total = 0.0
    for row in rows:
        out = logits(params, row[:-1], cfg, precision, remat=precision != "fp32")
        total = total + F.cross_entropy(out, row[1:], reduction="sum")
    return total


def train_steps(params: dict, batches, cfg: dict, opt: dict, steps: int,
                rows_per_block: int = 1, precision: str = "fp32") -> dict:
    """``steps`` steps of clip-by-global-norm + AdamW (optax's chain:
    m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2, bias-corrected, update
    m^/(sqrt(v^)+eps) + wd p, times lr) on the mean next-token NLL of each
    batch (B, S+1), in place on ``params`` (a tree of float32 leaves).

    Returns the losses and the norm of each leaf's first gradient as the
    optimizer takes it (clipped), by the leaf's dotted name."""
    from kubebench.weights import named

    leaves = named(params)
    for t in leaves.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    losses, first = [], {}
    for step in range(steps):
        batch = batches[step]
        B, T = batch.shape
        loss = 0.0
        for start in range(0, B, rows_per_block):
            rows = batch[start:start + rows_per_block]
            part = _nll_sum(params, rows, cfg, precision) / (B * (T - 1))
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {k: t.grad for k, t in leaves.items()}
            norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values()))
            scale = 1.0 if norm < opt["max_norm"] else float(opt["max_norm"] / norm)
            b1, b2, lr = opt["b1"], opt["b2"], opt["lr"]
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for k, p in leaves.items():
                g = grads[k] * scale
                if step == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / c1) / ((v[k] / c2).sqrt() + opt["eps"]) + opt["weight_decay"] * p
                p.sub_(lr * upd)
                p.grad = None
    for t in leaves.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first}
