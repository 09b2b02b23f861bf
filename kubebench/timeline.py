"""Interval arithmetic over device traces, and the import check; no
torch, so the benchmark's own process can use it before torch loads."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "tpukube")
# idle stretches shorter than this are not labelled or reported
GAP_MIN_NS = 20_000


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def merge(spans) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, s0: int, s1: int) -> list:
    """The idle (start, end) stretches of [s0, s1] outside ``busy`` (merged
    and inside it) that last at least GAP_MIN_NS."""
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] - edges[i] >= GAP_MIN_NS]
