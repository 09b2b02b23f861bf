"""Weights of the MLA + MoE decoder (``"family": "mla_moe"``) made on the
device from ``--seed``, in the port's parameter layout
(``tpukube_torch.workload.mla_moe``: float32 leaves stacked by layer kind,
``dense`` for the first ``first_k_dense_replace`` layers and ``moe`` for
the rest; the routed experts stacked (L, E, D, F) and (L, E, F, D)).

As ``weights.py`` does for the other families: each leaf drawn from a
generator of its own, so that the program (in its pod) and the plain
reference (after the window) get the same numbers from the same seed.
Products are N(0, 1/fan_in), norm gains N(1, 0.1**2), the router's score
correction ``b`` N(0, s**2) with s the configuration's
``assumed.e_score_correction_bias_std``. Tokens come from
``weights.token_pool``; the positions and columns at which a pod keeps
logits for the check, from :func:`logit_positions` and
:func:`logit_columns`. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from kubebench.traffic import subseed
from kubebench.weights import _normal, nest

GAIN = (0.1, 1.0)  # norm gains near one, so that the check sees them


def _attention(cfg: dict, kind: str, L: int) -> list:
    D, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return [
        ((kind, "attn_norm"), (L, D), *GAIN),
        ((kind, "wq"), (L, D, H * (dn + dr)), D ** -0.5, 0.0),
        ((kind, "wkv_a"), (L, D, r + dr), D ** -0.5, 0.0),
        ((kind, "kv_norm"), (L, r), *GAIN),
        ((kind, "wkv_b"), (L, r, H * (dn + dv)), r ** -0.5, 0.0),
        ((kind, "wo"), (L, H * dv, D), (H * dv) ** -0.5, 0.0),
        ((kind, "mlp_norm"), (L, D), *GAIN),
    ]


def layout(cfg: dict) -> list:
    """(path, shape, scale, shift) of every leaf; a leaf is N(shift,
    scale**2)."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    Ld = cfg["first_k_dense_replace"]
    Lm = cfg["num_hidden_layers"] - Ld
    Fd, E, Fe = cfg["intermediate_size"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    Fs = cfg["n_shared_experts"] * Fe
    return ([(("embed",), (V, D), D ** -0.5, 0.0)]
            + _attention(cfg, "dense", Ld)
            + [(("dense", "w_gate"), (Ld, D, Fd), D ** -0.5, 0.0),
               (("dense", "w_up"), (Ld, D, Fd), D ** -0.5, 0.0),
               (("dense", "w_down"), (Ld, Fd, D), Fd ** -0.5, 0.0)]
            + _attention(cfg, "moe", Lm)
            + [(("moe", "router"), (Lm, D, E), D ** -0.5, 0.0),
               (("moe", "router_bias"), (Lm, E), cfg["assumed"]["e_score_correction_bias_std"], 0.0),
               (("moe", "w_gate"), (Lm, E, D, Fe), D ** -0.5, 0.0),
               (("moe", "w_up"), (Lm, E, D, Fe), D ** -0.5, 0.0),
               (("moe", "w_down"), (Lm, E, Fe, D), Fe ** -0.5, 0.0),
               (("moe", "shared_gate"), (Lm, D, Fs), D ** -0.5, 0.0),
               (("moe", "shared_up"), (Lm, D, Fs), D ** -0.5, 0.0),
               (("moe", "shared_down"), (Lm, Fs, D), Fs ** -0.5, 0.0)]
            + [(("final_norm",), (D,), *GAIN), (("unembed",), (D, V), D ** -0.5, 0.0)])


def leaf(cfg: dict, seed: int, index: int, device: torch.device) -> torch.Tensor:
    _, shape, scale, shift = layout(cfg)[index]
    return _normal(shape, scale, shift, seed, (40, index), device)


def params(cfg: dict, seed: int, device: torch.device) -> dict:
    return nest((path, leaf(cfg, seed, i, device)) for i, (path, *_) in enumerate(layout(cfg)))


def logit_columns(seed: int, vocab: int, n: int, device: torch.device) -> torch.Tensor:
    """The ``n`` vocabulary columns, drawn from the seed, at which a pod
    keeps the logits of the positions it samples (sorted)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, 41))
    return torch.randperm(vocab, generator=g, device=device)[:n].sort().values


def logit_positions(length: int, n: int, device: torch.device) -> torch.Tensor:
    """``n`` positions of a prompt of ``length`` tokens, evenly spaced, the
    first and the last among them."""
    return torch.arange(n, device=device) * (length - 1) // (n - 1)
