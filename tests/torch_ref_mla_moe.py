"""Plain PyTorch reference of the MLA + MoE decoder (the port's
``tpukube_torch/workload/mla_moe.py``), for the tests: DeepSeek-V3's
published layer equations at a ``config.json``'s keys, float32 with TF32
off, one routed expert at a time, no grouped product and no kernel. It
imports nothing of the program and nothing of JAX.

Per block, over h (S, D):

- ``a = RMSNorm(h; g_attn)``; ``q = a W_q`` as (S, H, dn + dr) =
  [q_nope | q_pe]; ``c = a W_kv_a`` of width r + dr = [c_kv | k_pe];
  ``kv = RMSNorm(c_kv; g_kv) W_kv_b`` as (S, H, dn + dv) = [k_nope | v],
  the latent norm at the published code's default epsilon, 1e-6;
- rotary embedding at ``rope_theta`` on q_pe and on k_pe: halves by
  default, or the published code's interleaved pairs (``interleaved``);
  the two are one model under a fixed permutation of the rope columns of
  W_q and W_kv_a (:func:`halves_from_interleaved`); k_pe is one head,
  broadcast over all H;
- ``k = [k_nope | k_pe]``, scores ``q.k / sqrt(dn + dr)``, causal softmax,
  ``h += (P v) W_o``;
- ``m = RMSNorm(h; g_mlp)``; the first ``first_k_dense_replace`` layers add
  ``SwiGLU(m)`` at ``intermediate_size``; the others: ``s = sigmoid(m
  W_r)``, the top ``num_experts_per_tok`` of ``s + b`` chosen (``b`` for
  the choice only), ``w_i = s_i / (sum_top s + 1e-20) *
  routed_scaling_factor``, ``h += sum_top w_i SwiGLU_i(m) +
  SwiGLU_shared(m)`` (routed width ``moe_intermediate_size``, the shared
  one ``n_shared_experts`` times it).

A final RMSNorm and the untied unembedding give the logits. Parameters
come in the port's tree: leaves stacked by layer kind (``dense``,
``moe``), the experts as (L, E, D, F) and (L, E, F, D).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LATENT_EPS = 1e-6


def precise() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rotary(x, theta, interleaved=False):
    """x (S, N, d) rotated by position: halves (x[:d/2], x[d/2:]) or, with
    ``interleaved``, pairs (x[2i], x[2i+1]), at the same frequencies."""
    S, _, d = x.shape
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_permutation(d: int) -> torch.Tensor:
    """Halves' column j reads the interleaved form's column perm[j]: the even
    rope dims first, then the odd."""
    return torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])


def halves_from_interleaved(params: dict, cfg: dict) -> dict:
    """The tree whose halves model equals ``params``' interleaved one: the
    rope columns of every W_q head and of W_kv_a permuted."""
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    perm = rope_permutation(dr)
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    for kind in ("dense", "moe"):
        wq = params[kind]["wq"]
        heads = wq.reshape(*wq.shape[:-1], H, dn + dr)
        rope = heads[..., dn:][..., perm]
        out[kind]["wq"] = torch.cat([heads[..., :dn], rope], dim=-1).reshape(wq.shape)
        wkv_a = params[kind]["wkv_a"]
        out[kind]["wkv_a"] = torch.cat([wkv_a[..., :r], wkv_a[..., r:][..., perm]], dim=-1)
    return out


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def attention(h, layer: dict, cfg: dict, interleaved=False):
    S = h.shape[0]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    theta = cfg["rope_theta"]
    a = rms_norm(h, layer["attn_norm"], cfg["rms_norm_eps"])
    q = (a @ layer["wq"]).view(S, H, dn + dr)
    c = a @ layer["wkv_a"]
    kv = (rms_norm(c[:, :r], layer["kv_norm"], LATENT_EPS) @ layer["wkv_b"]).view(S, H, dn + dv)
    q = torch.cat([q[..., :dn], rotary(q[..., dn:], theta, interleaved)], dim=-1)
    k_pe = rotary(c[:, None, r:], theta, interleaved).expand(S, H, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    v = kv[..., dn:]
    scores = (q.transpose(0, 1) @ k.permute(1, 2, 0)) / math.sqrt(dn + dr)
    future = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = (probs @ v.transpose(0, 1)).transpose(0, 1).reshape(S, H * dv)
    return ctx @ layer["wo"]


def route(m, layer: dict, cfg: dict):
    """-> the chosen experts (S, k) and their weights."""
    s = torch.sigmoid(m @ layer["router"])
    chosen = torch.topk(s + layer["router_bias"], cfg["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, chosen)
    return chosen, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]


def moe(m, layer: dict, cfg: dict):
    chosen, w = route(m, layer, cfg)
    y = swiglu(m, layer["shared_gate"], layer["shared_up"], layer["shared_down"])
    for e in range(cfg["n_routed_experts"]):
        rows, j = torch.nonzero(chosen == e, as_tuple=True)
        if len(rows):
            out = swiglu(m[rows], layer["w_gate"][e], layer["w_up"][e], layer["w_down"][e])
            y = y.index_add(0, rows, out * w[rows, j][:, None])
    return y


def layer_at(params: dict, cfg: dict, i: int) -> tuple[dict, bool]:
    """Layer ``i``'s leaves and whether it is dense."""
    nd = cfg["first_k_dense_replace"]
    stack, j = (params["dense"], i) if i < nd else (params["moe"], i - nd)
    return {k: v[j] for k, v in stack.items()}, i < nd


def logits(params: dict, tokens: torch.Tensor, cfg: dict, interleaved=False) -> torch.Tensor:
    """tokens (S,) -> logits (S, vocab) float32."""
    eps = cfg["rms_norm_eps"]
    h = params["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        layer, dense = layer_at(params, cfg, i)
        h = h + attention(h, layer, cfg, interleaved)
        m = rms_norm(h, layer["mlp_norm"], eps)
        if dense:
            h = h + swiglu(m, layer["w_gate"], layer["w_up"], layer["w_down"])
        else:
            h = h + moe(m, layer, cfg)
    return rms_norm(h, params["final_norm"], eps) @ params["unembed"]
