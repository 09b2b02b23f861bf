"""Plain PyTorch reference of the MLA + MoE decoder: DeepSeek-V3's layer
equations at a ``config.json``'s keys (``configs/moonlight-16b-a3b.json``),
written from the published modelling code and not from the program.

Per block, over h (S, D):

- ``a = RMSNorm(h; g_attn)``; ``q = a W_q`` as (S, H, dn + dr) =
  [q_nope | q_pe]; ``c = a W_kv_a`` of width r + dr = [c_kv | k_pe];
  ``kv = RMSNorm(c_kv; g_kv) W_kv_b`` as (S, H, dn + dv) = [k_nope | v]
  (the latent norm's epsilon is the published code's default, 1e-6);
- rotary embedding at ``rope_theta`` on q_pe and on k_pe, each split in
  halves (the published code's interleaved pairs, under one fixed
  permutation of the rope columns of W_q and W_kv_a: the same model with
  seeded weights); k_pe is one head, broadcast over all H;
- ``k = [k_nope | k_pe]``, scores ``q.k / sqrt(dn + dr)``, causal softmax,
  ``h += (P v) W_o``;
- ``m = RMSNorm(h; g_mlp)``; the first ``first_k_dense_replace`` layers add
  ``SwiGLU(m)`` at ``intermediate_size``; the others route: ``s =
  sigmoid(m W_r)``, the top ``num_experts_per_tok`` of ``s + b`` chosen
  (``b`` the score correction, for the choice only), weights ``s_i /
  (sum_top s + 1e-20) * routed_scaling_factor``, and add ``sum_top w_i
  SwiGLU_i(m) + SwiGLU_shared(m)``, each routed expert of width
  ``moe_intermediate_size``, the shared one ``n_shared_experts`` times it.
  One expert at a time, over the rows routed to it.

:func:`forward` can replay another's routing (the program's, which it
reports): the same equations with the choice of experts given. Random
weights put many tokens' scores within rounding of a tie, so a bfloat16
program chooses other experts than the float32 reference for 10-28% of
the tokens of a layer, and its trajectory leaves the reference's; replayed,
the two differ by rounding alone. Each replayed choice is held to the
reference's scores: its shortfall, how far its summed ``s + b`` falls
below the best choice's.

A final RMSNorm and the untied unembedding give the logits.

Everything is float32 with TF32 off (:func:`precise`). ``precision="fp8"``
is the control: every product's operands rounded to float8 e4m3 (scaled
per tensor), summed in float32; the router's product stays float32, as
the published gate computes it in float32.

Parameters come in the port's layout (stacked by layer kind, ``dense`` and
``moe``; see ``kubebench.weights_mla_moe``), made by the benchmark from
the seed; nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from kubebench.reference.decoder import operand, precise, rms_norm  # noqa: F401

LATENT_EPS = 1e-6


def _mm(a, b, precision):
    return operand(a, precision) @ operand(b, precision)


def rotary(x, theta):
    """x (S, N, d) rotated by position, halves."""
    S, _, d = x.shape
    half = d // 2
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, w_gate, w_up, w_down, precision):
    return _mm(F.silu(_mm(x, w_gate, precision)) * _mm(x, w_up, precision), w_down, precision)


def attention(h, layer: dict, cfg: dict, precision: str):
    S = h.shape[0]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    a = rms_norm(h, layer["attn_norm"], cfg["rms_norm_eps"])
    q = _mm(a, layer["wq"], precision).view(S, H, dn + dr)
    c = _mm(a, layer["wkv_a"], precision)
    kv = _mm(rms_norm(c[:, :r], layer["kv_norm"], LATENT_EPS), layer["wkv_b"], precision)
    kv = kv.view(S, H, dn + dv)
    q = torch.cat([q[..., :dn], rotary(q[..., dn:], cfg["rope_theta"])], dim=-1)
    k_pe = rotary(c[:, None, r:], cfg["rope_theta"]).expand(S, H, dr)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    v = kv[..., dn:]
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), precision) / math.sqrt(dn + dr)
    future = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = _mm(probs, v.transpose(0, 1), precision).transpose(0, 1).reshape(S, H * dv)
    return _mm(ctx, layer["wo"], precision)


def route(m, layer: dict, cfg: dict, given=None):
    """-> the chosen experts (S, k), their weights and, for each token, how
    far the chosen experts' summed ``s + b`` falls below the best k's (0
    where the choice is the reference's own). ``given`` replays another's
    choice: its weights are then the reference's own scores at it."""
    s = torch.sigmoid(m @ layer["router"])
    score = s + layer["router_bias"]
    best = torch.topk(score, cfg["num_experts_per_tok"], dim=-1)
    chosen = best.indices if given is None else given
    shortfall = best.values.sum(-1) - score.gather(-1, chosen).sum(-1)
    w = s.gather(-1, chosen)
    return chosen, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"], shortfall


def moe(m, layer: dict, cfg: dict, precision: str, given=None):
    """-> the layer's output, its choice and its shortfall (:func:`route`)."""
    chosen, w, shortfall = route(m, layer, cfg, given)
    y = swiglu(m, layer["shared_gate"], layer["shared_up"], layer["shared_down"], precision)
    for e in range(cfg["n_routed_experts"]):
        rows, j = torch.nonzero(chosen == e, as_tuple=True)
        if len(rows):
            out = swiglu(m[rows], layer["w_gate"][e], layer["w_up"][e], layer["w_down"][e],
                         precision)
            y = y.index_add(0, rows, out * w[rows, j][:, None])
    return y, chosen, shortfall


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def forward(params: dict, tokens: torch.Tensor, cfg: dict, precision: str = "fp32",
            routes=None) -> tuple:
    """tokens (S,) -> (logits (S, vocab) float32, each MoE layer's choice
    (S, k), each MoE layer's shortfall (S,)). ``routes`` (a choice a MoE
    layer, in order) replays another's routing."""
    eps, nd = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    h = params["embed"][tokens]
    chosen, shortfall = [], []
    for i in range(cfg["num_hidden_layers"]):
        layer = _layer(params["dense"], i) if i < nd else _layer(params["moe"], i - nd)
        h = h + attention(h, layer, cfg, precision)
        m = rms_norm(h, layer["mlp_norm"], eps)
        if i < nd:
            h = h + swiglu(m, layer["w_gate"], layer["w_up"], layer["w_down"], precision)
        else:
            y, c, short = moe(m, layer, cfg, precision, None if routes is None else routes[i - nd])
            h = h + y
            chosen.append(c)
            shortfall.append(short)
    h = rms_norm(h, params["final_norm"], eps)
    return _mm(h, params["unembed"], precision), chosen, shortfall


def logits(params: dict, tokens: torch.Tensor, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """tokens (S,) -> logits (S, vocab) float32, routed by the reference."""
    return forward(params, tokens, cfg, precision)[0]
