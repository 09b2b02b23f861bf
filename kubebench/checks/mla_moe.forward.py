"""``correct`` for ``mla_moe.forward``: the pods' sampled requests (the
longest among them), held against the MLA + MoE reference run once over
each prompt with the program's routing replayed (the program reports
which experts each MoE layer chose for each token).

Random weights put many tokens' router scores within rounding of a tie:
a bfloat16 program chooses other experts than the float32 reference for
10-28% of a layer's tokens at Moonlight's size, and from there its
activations leave the reference's, whatever their precision. Replayed,
the reference follows the program's choices, and the two differ by
rounding alone; each choice is held to the reference's own scores apart.

- ``served_logit_gap``: the widest gap, over every position, by which a
  served next token's reference logit lies below the reference's best.
- ``logit_error_median``: at each position whose logits the pod kept (a
  few evenly spaced positions a request, a seeded set of vocabulary
  columns), the norm of the program's logits less the reference's over
  the norm of the reference's; the median over those positions.
- ``route_shortfall_mean``: for each token and MoE layer, how far the
  program's chosen experts' summed ``s + b``, in the reference's scores,
  falls below the best choice's; the mean over every token and layer.
"""

import base64
import statistics

import numpy as np
import torch

from kubebench import weights, weights_mla_moe
from kubebench.reference import mla_moe as ref


def _gap(out: torch.Tensor, served: torch.Tensor) -> float:
    return float((out.max(-1).values - out.gather(-1, served.long()[:, None])[:, 0]).max())


def _errors(want: torch.Tensor, got: torch.Tensor) -> list:
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)).tolist()


def _routes(packed: str, cfg: dict, length: int, device: torch.device) -> torch.Tensor:
    """The program's choices, (MoE layers, length, k)."""
    raw = np.frombuffer(base64.b64decode(packed), dtype=np.uint8)
    shape = (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"], length,
             cfg["num_experts_per_tok"])
    return torch.from_numpy(raw.copy()).reshape(shape).to(device=device, dtype=torch.int64)


class _Readings:
    def __init__(self):
        self.gap, self.errors, self.shortfall, self.choices = 0.0, [], 0.0, 0

    def add(self, out, served, kept, got, shortfall) -> None:
        self.gap = max(self.gap, _gap(out, served))
        self.errors += _errors(kept, got)
        self.shortfall += float(torch.stack(shortfall).double().sum())
        self.choices += sum(s.numel() for s in shortfall)

    def numbers(self) -> dict:
        return {"served_logit_gap": self.gap, "logit_error_median": statistics.median(self.errors),
                "route_shortfall_mean": self.shortfall / self.choices}


@torch.no_grad()
def check(cell, seed: int, reports: list, device: torch.device) -> dict:
    ref.precise()
    cfg, t = cell.config, cell.traffic
    params = weights_mla_moe.params(cfg, seed, device)
    pool = weights.token_pool(seed, t["token_pool"], cfg["vocab_size"], device)
    got, served = _Readings(), 0
    for r in reports:
        cols = torch.tensor(r["logit_columns"], device=device)
        for s in r["sample"]:
            routes = _routes(s["routes"], cfg, s["length"], device)
            out, _, shortfall = ref.forward(params, pool[s["offset"]:s["offset"] + s["length"]],
                                            cfg, routes=routes)
            kept = out[torch.tensor(s["positions"], device=device)][:, cols]
            got.add(out, torch.tensor(s["served"], device=device), kept,
                    torch.tensor(s["logits"], device=device), shortfall)
            served += len(s["served"])
    return {**got.numbers(), "served_tokens": served, "logit_positions": len(got.errors)}


@torch.no_grad()
def control(cell, seed: int, lengths: list, device: torch.device, precision: str) -> dict:
    """The same readings for the reference at ``precision`` in the
    program's place (its own routing, replayed as the program's is), on
    prompts of ``lengths`` drawn from the pool as a run draws them."""
    ref.precise()
    cfg, t = cell.config, cell.traffic
    params = weights_mla_moe.params(cfg, seed, device)
    pool = weights.token_pool(seed, t["token_pool"], cfg["vocab_size"], device)
    cols = weights_mla_moe.logit_columns(seed, cfg["vocab_size"], t["check_logit_columns"], device)
    g = torch.Generator().manual_seed(seed)
    got = _Readings()
    for n in lengths:
        off = int(torch.randint(t["token_pool"] - n + 1, (1,), generator=g))
        toks = pool[off:off + n]
        low, routes, _ = ref.forward(params, toks, cfg, precision)
        out, _, shortfall = ref.forward(params, toks, cfg, routes=routes)
        pos = weights_mla_moe.logit_positions(n, t["check_positions_per_request"], device)
        got.add(out, low.argmax(-1), out[pos][:, cols], low[pos][:, cols], shortfall)
        del low, out
    return got.numbers()
