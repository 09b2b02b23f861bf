"""Reconnect backoff — the port's own copy of the part of
``tpukube/core/retry.py`` its loops use: :class:`RetryPolicy`'s jittered
exponential delay and :class:`Backoff`, the delay sequence as state for a
loop that backs off BETWEEN iterations (the pod watch's reconnects in
``tpukube_torch.apiserver``).

The reference's ``Retrier``, ``CircuitBreaker`` and their counters wait
with the apiserver REST channel they guard (not ported).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: attempt ``n`` (1-based) failing
    sleeps ``min(max_delay, base_delay * 2**(n-1))`` scaled down by up
    to ``jitter`` (full-jitter style: a fleet of retriers must not
    re-dogpile the apiserver in lockstep). The reference's attempt cap
    and deadlines belong to its ``Retrier`` and are not ported."""

    base_delay: float = 0.1
    max_delay: float = 5.0
    jitter: float = 0.5

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt`` (1-based failures)."""
        d = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        if self.jitter > 0:
            d *= 1.0 - self.jitter * rng.random()
        return d


class Backoff:
    """The policy's delay sequence as reusable state, for loops that
    back off BETWEEN iterations (informer reconnects): ``next()``
    returns the delay for one more consecutive failure, ``reset()``
    re-arms after success. Thread-compatible (each loop owns one)."""

    def __init__(self, base: float, cap: float, jitter: float = 0.5,
                 rng: Optional[random.Random] = None) -> None:
        self._policy = RetryPolicy(base_delay=base, max_delay=cap,
                                   jitter=jitter)
        self._rng = rng or random.Random()
        self.failures = 0

    def next(self) -> float:
        self.failures += 1
        return self._policy.delay(self.failures, self._rng)

    def reset(self) -> None:
        self.failures = 0
