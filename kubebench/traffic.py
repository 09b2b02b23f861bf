"""The one traffic generator: what a mix file's parameters turn into.

Everything here is a function of ``--seed`` and the mix file, so the same
seed gives the same requests, and every seed gives the same *set* of
sizes in another order (a run's work does not change with the seed).
Imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

MASK63 = (1 << 63) - 1


def subseed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream (a leaf, the tokens, a client),
    derived from ``--seed``, which may exceed 32 bits."""
    state = np.random.SeedSequence([seed & MASK63, *salt]).generate_state(2, np.uint64)
    return int(state[0]) & MASK63


def lengths(spec: dict) -> list[int]:
    """The mix's fixed multiset of prompt lengths: ``points`` lengths
    spaced evenly in log between ``min`` and ``max``, both included."""
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi, n = spec["min"], spec["max"], spec["points"]
    return [int(round(lo * (hi / lo) ** (i / (n - 1)))) for i in range(n)]


@dataclass(frozen=True)
class Request:
    client: int
    index: int
    length: int
    offset: int


STRATA = 8


def _balanced(rng: np.random.Generator, n: int) -> list:
    """A permutation of range(n) (n lengths, sorted) in which every run of
    ``STRATA`` consecutive positions takes one length from each of
    ``STRATA`` bands of neighbouring lengths, so that any stretch of the
    stream holds nearly the same mix: the seed reorders the work and
    barely changes how much of it a window holds."""
    bands = [list(rng.permutation(b)) for b in np.array_split(np.arange(n), STRATA)]
    out = []
    while any(bands):
        out += [int(b.pop()) for b in (bands[i] for i in rng.permutation(STRATA)) if b]
    return out


class Client:
    """One closed-loop client's request stream: each pass over the mix's
    lengths is a fresh balanced permutation of them (:func:`_balanced`),
    and each request reads its tokens from a seeded offset into the
    shared token pool."""

    def __init__(self, traffic: dict, seed: int, client: int):
        self._lengths = lengths(traffic["prompt_tokens"])
        self._pool = traffic["token_pool"]
        if max(self._lengths) > self._pool:
            raise ValueError("token_pool is shorter than the longest prompt")
        self._rng = np.random.default_rng(subseed(seed, 1, client))
        self._client = client
        self._order: list[int] = []
        self._next = 0

    def next(self) -> Request:
        if not self._order:
            self._order = _balanced(self._rng, len(self._lengths))[::-1]
        length = self._lengths[self._order.pop()]
        offset = int(self._rng.integers(0, self._pool - length + 1))
        req = Request(self._client, self._next, length, offset)
        self._next += 1
        return req


def check_sample(done: list, seed: int, k: int) -> list:
    """The requests (of ``done``, each with ``.length``) whose served tokens
    are compared with the reference: the longest (the first of them), and
    ``k - 1`` more drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i].length, -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(subseed(seed, 2))
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(picked)]


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values`` (q in (0, 100])."""
    s = sorted(values)
    return s[max(math.ceil(q / 100 * len(s)) - 1, 0)]
