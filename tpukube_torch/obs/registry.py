"""Latency quantiles: the part of ``tpukube/obs/registry.py`` the port's
callers read (the reference's histograms wait with the extender's
``/metrics`` route, their only reader).
"""

from __future__ import annotations

from typing import Iterable


def quantile(values: Iterable[float], q: float) -> float:
    """Nearest-rank quantile; 0.0 on empty input."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = min(len(vs) - 1, max(0, round(q * (len(vs) - 1))))
    return vs[idx]
