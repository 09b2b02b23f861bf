"""``correct`` for ``llama.forward``: the served tokens of the pods' sampled
requests (the longest among them), held against the reference run once
over each prompt: the widest gap, over every position, by which a served
next token's reference logit lies below the reference's best."""

import torch

from kubebench import weights
from kubebench.reference import decoder as ref


def check(cell, seed: int, reports: list, device: torch.device) -> dict:
    ref.precise()
    cfg, t = cell.config, cell.traffic
    params = weights.decoder_params(cfg, seed, device)
    pool = weights.token_pool(seed, t["token_pool"], cfg["vocab_size"], device)
    gap, served = 0.0, 0
    for r in reports:
        for s in r["sample"]:
            toks = pool[s["offset"]:s["offset"] + s["length"]]
            tokens = torch.tensor(s["served"], device=device)
            gap = max(gap, ref.served_gap(params, toks, tokens, cfg))
            served += len(s["served"])
    return {"served_logit_gap": gap, "served_tokens": served}


def control(cell, seed: int, lengths: list, device: torch.device, precision: str) -> dict:
    """The same reading for the reference at ``precision`` in the program's
    place, on prompts of ``lengths`` drawn from the pool as a run draws
    them."""
    ref.precise()
    cfg, t = cell.config, cell.traffic
    params = weights.decoder_params(cfg, seed, device)
    pool = weights.token_pool(seed, t["token_pool"], cfg["vocab_size"], device)
    g = torch.Generator().manual_seed(seed)
    gap = 0.0
    for n in lengths:
        off = int(torch.randint(t["token_pool"] - n + 1, (1,), generator=g))
        toks = pool[off:off + n]
        gap = max(gap, ref.served_gap(params, toks, ref.greedy(params, toks, cfg, precision), cfg))
    return {"served_logit_gap": gap}
