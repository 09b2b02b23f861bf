"""A DeepSeek-V3-style decoder: latent attention (MLA) and a mixture of
experts with shared experts. Moonlight-16B-A3B (:meth:`MlaMoeConfig.
moonlight_16b_a3b`) is its published instance; nothing of it is in the
JAX package.

Notation: D model width, H heads, E routed experts, k experts a token,
F_e an expert's width. Each block takes ``h`` (S, D):

- ``a = RMSNorm(h; g_attn)``;
- ``q = a W_q``, (S, H, dn + dr) = [q_nope | q_pe];
- ``c = a W_kv_a``, of width r + dr = [c_kv | k_pe];
- ``kv = RMSNorm(c_kv; g_kv) W_kv_b``, (S, H, dn + dv) = [k_nope | v];
- RoPE on ``q_pe`` and on ``k_pe``; ``k_pe`` is one head, shared by all H;
- ``k = [k_nope | k_pe]``; scores ``q.k / sqrt(dn + dr)``, causal,
  softmax; ``h += (P v) W_o``, ``W_o`` of shape (H dv, D);
- ``m = RMSNorm(h; g_mlp)``;
- the first ``first_dense`` layers: ``h += SwiGLU(m)`` at ``d_ff_dense``;
- the others: router logits ``z = m W_r`` in float32 (``m`` cast to
  float32, as the published gate does), ``s = sigmoid(z)``, the top k of
  ``s + b`` chosen (``b`` the float32 score correction, used for the
  choice only), weights ``w_i = s_i / (sum_top s + 1e-20) * scale``;
  ``h += sum_top w_i SwiGLU_i(m) + SwiGLU_shared(m)``, the shared experts
  one SwiGLU of width ``n_shared * F_e``, the sum in float32 and cast back
  once;
- then the final RMSNorm and the untied unembedding: float32 logits.

These follow DeepSeek-V3's published modelling code, with one departure:
that code rotates interleaved pairs of the dr rope dims, this module
rotates halves (:func:`llama._rope`) at the same frequencies. The two
differ by one fixed permutation of ``W_q``'s and ``W_kv_a``'s rope columns
(the even ones first, then the odd); with seeded random weights they are
the same model. The latent norm's epsilon is the published code's default
for that norm (:data:`LATENT_NORM_EPS`), not ``rms_norm_eps``.

Compute is bfloat16 (``llama.COMPUTE_DTYPE``, read at each call) at the
decoder's rounding points: float32 leaves cast to the compute dtype where
used, RMSNorm statistics in float32, the attention core shared with the
decoder (:func:`llama.causal_attention`: dq 192, dv 128, kv heads = H).
The router is the exception: float32 throughout.

Dispatch drops no token and does not loop over experts: the (token,
choice) pairs are sorted by expert once a layer, and each expert
projection is one grouped product over all E experts
(``torch._grouped_mm`` with the experts' row offsets); the outputs go back
to token order and are summed with their weights. Nothing waits for the
device on the way.

Parameters are float32 leaves stacked by layer kind: ``dense`` (the first
layers) and ``moe`` (the rest), each with a leading layer axis; the routed
experts are stacked (L, E, D, F_e) and (L, E, F_e, D).

While a torch profiler runs, :func:`forward` is a ``tpukube.forward``
span; each block's attention core a ``tpukube.attention`` and each MoE
layer's router, dispatch, experts and combine one ``tpukube.moe``, both
direct children of the forward; ``tpukube.moe`` counts the rows routed to
each expert (``rows_per_expert``, read at export).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from tpukube_torch.obs.spans import span
from tpukube_torch.workload import llama
from tpukube_torch.workload.llama import _rmsnorm, _rope, causal_attention, tree_from_leaves

# the published modelling code builds the latent's RMSNorm with its
# class default, not config.json's rms_norm_eps
LATENT_NORM_EPS = 1e-6
# the router's score correction is a trained buffer; drawn N(0, BIAS_STD**2)
BIAS_STD = 0.01


@dataclass(frozen=True)
class MlaMoeConfig:
    vocab: int = 256
    d_model: int = 64
    n_layers: int = 3
    first_dense: int = 1
    n_heads: int = 4
    kv_rank: int = 32
    qk_nope_dim: int = 16
    qk_rope_dim: int = 8
    v_dim: int = 16
    d_ff_dense: int = 128
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 32
    n_shared: int = 2
    routed_scale: float = 2.446
    rope_theta: float = 50_000.0
    norm_eps: float = 1e-5

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.first_dense

    @staticmethod
    def moonlight_16b_a3b() -> "MlaMoeConfig":
        """Moonlight-16B-A3B's published shape (its HF ``config.json``)."""
        return MlaMoeConfig(
            vocab=163_840, d_model=2048, n_layers=27, first_dense=1, n_heads=16,
            kv_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128, d_ff_dense=11_264,
            n_experts=64, top_k=6, d_expert=1408, n_shared=2, routed_scale=2.446,
            rope_theta=50_000.0, norm_eps=1e-5)


def _attention_layout(cfg: MlaMoeConfig, L: int) -> list:
    """(key, shape, fan_in) of one kind's attention leaves, fan_in None for
    a norm gain."""
    D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_rank
    return [
        ("attn_norm", (L, D), None),
        ("wq", (L, D, H * cfg.qk_dim), D),
        ("wkv_a", (L, D, r + cfg.qk_rope_dim), D),
        ("kv_norm", (L, r), None),
        ("wkv_b", (L, r, H * (cfg.qk_nope_dim + cfg.v_dim)), r),
        ("wo", (L, H * cfg.v_dim, D), H * cfg.v_dim),
        ("mlp_norm", (L, D), None),
    ]


def layout(cfg: MlaMoeConfig) -> list:
    """(path, shape, fan_in) of every leaf, in :func:`init_leaves`' order;
    fan_in None for a norm gain, 0 for the router's score correction."""
    D, V, E, Fe = cfg.d_model, cfg.vocab, cfg.n_experts, cfg.d_expert
    Ld, Lm, Fs = cfg.first_dense, cfg.n_moe, cfg.n_shared * cfg.d_expert
    out = [(("embed",), (V, D), D)]
    out += [(("dense", k), s, f) for k, s, f in _attention_layout(cfg, Ld)]
    out += [(("dense", "w_gate"), (Ld, D, cfg.d_ff_dense), D),
            (("dense", "w_up"), (Ld, D, cfg.d_ff_dense), D),
            (("dense", "w_down"), (Ld, cfg.d_ff_dense, D), cfg.d_ff_dense)]
    out += [(("moe", k), s, f) for k, s, f in _attention_layout(cfg, Lm)]
    out += [(("moe", "router"), (Lm, D, E), D),
            (("moe", "router_bias"), (Lm, E), 0),
            (("moe", "w_gate"), (Lm, E, D, Fe), D),
            (("moe", "w_up"), (Lm, E, D, Fe), D),
            (("moe", "w_down"), (Lm, E, Fe, D), Fe),
            (("moe", "shared_gate"), (Lm, D, Fs), D),
            (("moe", "shared_up"), (Lm, D, Fs), D),
            (("moe", "shared_down"), (Lm, Fs, D), Fs)]
    out += [(("final_norm",), (D,), None), (("unembed",), (D, V), D)]
    return out


def init_leaves(generator: torch.Generator, cfg: MlaMoeConfig,
                device: torch.device) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """The float32 leaves as (path, tensor), drawn from ``generator`` (on
    ``device``) in :func:`layout`'s order: products N(0, 1/fan_in), norm
    gains one, the score correction N(0, BIAS_STD**2)."""
    for path, shape, fan_in in layout(cfg):
        if fan_in is None:
            yield path, torch.ones(shape, device=device, dtype=torch.float32)
            continue
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        yield path, t.mul_(fan_in ** -0.5 if fan_in else BIAS_STD)


def init_params(generator: torch.Generator, cfg: MlaMoeConfig, device: torch.device) -> dict:
    return tree_from_leaves(init_leaves(generator, cfg, device))


def _swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return (F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))) @ w_down.to(dt)


def _attention(h: torch.Tensor, layer: dict, cfg: MlaMoeConfig) -> torch.Tensor:
    """Latent attention's contribution to the residual over h (B, S, D)."""
    B, S, _ = h.shape
    H, dn, dr, dv, r = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim, cfg.kv_rank
    a = _rmsnorm(h, layer["attn_norm"], cfg.norm_eps)
    q = (a @ layer["wq"].to(a.dtype)).reshape(B, S, H, dn + dr)
    c = a @ layer["wkv_a"].to(a.dtype)
    kv = _rmsnorm(c[..., :r], layer["kv_norm"], LATENT_NORM_EPS) @ layer["wkv_b"].to(a.dtype)
    kv = kv.reshape(B, S, H, dn + dv)
    q_pe = _rope(q[..., dn:], cfg.rope_theta)
    k_pe = _rope(c[..., None, r:], cfg.rope_theta)  # one head, shared by all H
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
    return causal_attention(q, k, kv[..., dn:]) @ layer["wo"].to(a.dtype)


def route(m: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          cfg: MlaMoeConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """m (T, D) -> the chosen experts (T, k) and their float32 weights."""
    s = torch.sigmoid(m.float() @ router.float())
    chosen = torch.topk(s + bias, cfg.top_k, dim=-1).indices
    w = s.gather(-1, chosen)
    return chosen, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def experts_grouped(x: torch.Tensor, chosen: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's chosen experts over x (T, D), with every projection one
    grouped product over the experts (their leaves (E, D, F) and (E, F, D)).
    -> (the outputs (T, k, D) in the compute dtype, the rows each expert
    received (E,))."""
    T, k = chosen.shape
    E = w_gate.shape[0]
    experts, order = torch.sort(chosen.reshape(-1), stable=True)
    ends = torch.searchsorted(experts, torch.arange(E, device=x.device), right=True)
    offs = ends.to(torch.int32)
    xs = x[order // k]
    dt = x.dtype
    act = (F.silu(torch._grouped_mm(xs, w_gate.to(dt), offs=offs))
           * torch._grouped_mm(xs, w_up.to(dt), offs=offs))
    out = torch._grouped_mm(act, w_down.to(dt), offs=offs)
    # back to token order: row t * k + j is token t's j-th choice
    back = torch.empty_like(out).index_copy_(0, order, out)
    return back.reshape(T, k, -1), torch.diff(ends, prepend=ends.new_zeros(1))


def _moe(m: torch.Tensor, layer: dict, cfg: MlaMoeConfig, routes: Optional[list]) -> torch.Tensor:
    """The MoE layer's contribution to the residual over m (B, S, D)."""
    B, S, D = m.shape
    with span("tpukube.moe", m) as sp:
        x = m.reshape(B * S, D)
        chosen, w = route(x, layer["router"], layer["router_bias"], cfg)
        if routes is not None:
            routes.append(chosen)
        out, rows = experts_grouped(x, chosen, layer["w_gate"], layer["w_up"], layer["w_down"])
        sp.count("rows_per_expert", rows)
        shared = _swiglu(x, layer["shared_gate"], layer["shared_up"], layer["shared_down"])
        y = (out.float() * w[..., None]).sum(1) + shared.float()
        return y.to(m.dtype).reshape(B, S, D)


def forward(params: dict, tokens: torch.Tensor, cfg: MlaMoeConfig,
            routes: Optional[list] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) float32. ``routes``, where
    given, receives each MoE layer's chosen experts (B * S, k), in layer
    order, as they are made (nothing waits for them)."""
    with span("tpukube.forward", tokens):
        h = params["embed"][tokens].to(llama.COMPUTE_DTYPE)
        for kind in ("dense", "moe"):
            layers = params[kind]
            for i in range(layers["wq"].shape[0]):
                layer = {k: v[i] for k, v in layers.items()}
                h = h + _attention(h, layer, cfg)
                m = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
                if kind == "moe":
                    h = h + _moe(m, layer, cfg, routes)
                else:
                    h = h + _swiglu(m, layer["w_gate"], layer["w_up"], layer["w_down"])
        h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return (h @ params["unembed"].to(h.dtype)).float()
