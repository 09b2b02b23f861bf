"""Retry and backoff — the port's own copy of the part of
``tpukube/core/retry.py`` its seams use:

  * :class:`RetryPolicy` — jittered exponential backoff with a
    max-attempt cap, a per-attempt timeout hint and an overall deadline;
  * :class:`Backoff` — the policy's delay sequence as state, for a loop
    that backs off BETWEEN iterations (the pod watch's reconnects in
    ``tpukube_torch.apiserver``);
  * :class:`Retrier` — runs a callable under a policy, counting
    attempts, retries and exhaustions for ``/metrics`` and journaling
    ``RetryExhausted`` when it gives up (the device plugin's kubelet
    registration, ``plugin/server.py``).

Clocks, sleeps and randomness are injectable, so tests are
deterministic. The reference's ``CircuitBreaker`` waits with the
apiserver REST channel it guards (not ported), so a port ``Retrier`` has
no circuit.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger("tpukube_torch.retry")


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: attempt ``n`` (1-based) failing
    sleeps ``min(max_delay, base_delay * 2**(n-1))`` scaled down by up
    to ``jitter`` (full-jitter style: a fleet of retriers must not
    re-dogpile a peer in lockstep). ``deadline`` caps the whole call's
    wall budget (0 = unbounded); ``attempt_timeout`` is the per-attempt
    budget hint callers pass to their transport (0 = use the
    transport's own default)."""

    max_attempts: int = 5
    base_delay: float = 0.1
    max_delay: float = 5.0
    jitter: float = 0.5
    deadline: float = 30.0
    attempt_timeout: float = 0.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt`` (1-based failures)."""
        d = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        if self.jitter > 0:
            d *= 1.0 - self.jitter * rng.random()
        return d


def policy_from_config(cfg) -> RetryPolicy:
    """The one translation from the config's retry_* knobs."""
    return RetryPolicy(
        max_attempts=cfg.retry_max_attempts,
        base_delay=cfg.retry_base_delay_seconds,
        max_delay=cfg.retry_max_delay_seconds,
        jitter=cfg.retry_jitter,
        deadline=cfg.retry_deadline_seconds,
        attempt_timeout=cfg.retry_attempt_timeout_seconds,
    )


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


class RetryStats:
    """Thread-safe counters one Retrier exports on /metrics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._attempts = 0
        self._retries = 0
        self._exhausted = 0

    def note(self, attempts: int, exhausted: bool) -> None:
        with self._lock:
            self._attempts += attempts
            self._retries += attempts - 1
            if exhausted:
                self._exhausted += 1

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._attempts

    @property
    def retries(self) -> int:
        with self._lock:
            return self._retries

    @property
    def exhausted(self) -> int:
        with self._lock:
            return self._exhausted


def _default_retryable(exc: BaseException) -> bool:
    """Fallback classifier: retry ordinary failures, never programming
    errors or interpreter-level signals (KeyboardInterrupt/SystemExit
    must propagate immediately). Callers with richer error taxonomies
    pass their own predicate."""
    if not isinstance(exc, Exception):
        return False
    return not isinstance(exc, (TypeError, KeyError, AttributeError))


class Retrier:
    """Executes callables under one RetryPolicy."""

    def __init__(
        self,
        policy: RetryPolicy,
        name: str,
        retryable: Callable[[BaseException], bool] = _default_retryable,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        journal=None,
    ) -> None:
        self.policy = policy
        self.name = name
        self.stats = RetryStats()
        self._retryable = retryable
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self.journal = journal
        # attempts consumed by the most recent call() — single-threaded
        # callers (the kubelet session watcher) read this to learn
        # whether success needed a retry
        self.last_attempts = 0

    def _emit_exhausted(self, err: BaseException, attempts: int) -> None:
        if self.journal is None:
            return
        try:
            self.journal.emit(
                "RetryExhausted", obj=f"retry/{self.name}",
                message=f"gave up after {attempts} attempt(s): {err}",
                type="Warning",
            )
        except Exception:
            log.exception("event emit failed: RetryExhausted")

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` until success, a non-retryable error, attempt
        exhaustion, or the deadline. Raises the last error."""
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn()
            except BaseException as e:
                retryable = self._retryable(e)
                delay = self.policy.delay(attempt, self._rng)
                over_deadline = (
                    self.policy.deadline > 0
                    and self._clock() - start + delay > self.policy.deadline
                )
                if (not retryable or attempt >= self.policy.max_attempts
                        or over_deadline):
                    self.last_attempts = attempt
                    self.stats.note(attempt, exhausted=retryable)
                    if retryable:
                        why = ("deadline" if over_deadline else
                               "max attempts")
                        log.warning("%s: giving up after %d attempt(s) "
                                    "(%s): %s", self.name, attempt, why, e)
                        self._emit_exhausted(e, attempt)
                    raise
                log.info("%s: attempt %d failed (%s); retrying in %.3fs",
                         self.name, attempt, e, delay)
                self._sleep(delay)
                continue
            self.last_attempts = attempt
            self.stats.note(attempt, exhausted=False)
            return out
