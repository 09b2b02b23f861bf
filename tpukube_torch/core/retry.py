"""Retry, backoff and the circuit breaker — the port's own copy of
``tpukube/core/retry.py``:

  * :class:`RetryPolicy` — jittered exponential backoff with a
    max-attempt cap, a per-attempt timeout hint and an overall deadline;
  * :class:`Backoff` — the policy's delay sequence as state, for a loop
    that backs off BETWEEN iterations (the informer reconnects in
    ``tpukube_torch.apiserver``);
  * :class:`Retrier` — runs a callable under a policy, counting
    attempts, retries and exhaustions for ``/metrics`` and journaling
    ``RetryExhausted`` when it gives up (the device plugin's kubelet
    registration, ``plugin/server.py``; the REST channel's requests);
  * :class:`CircuitBreaker` — consecutive-failure trip wire with
    half-open probing: while open, callers fail fast instead of stacking
    timeouts onto a dead apiserver (``RestApiServer``'s ``circuit``).

Clocks, sleeps and randomness are injectable, so tests are
deterministic. A Retrier is only consulted where one is wired, and a
breaker with ``failure_threshold=0`` never trips (the config's default).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger("tpukube_torch.retry")

#: breaker states, exported as the tpukube_circuit_state gauge
CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: attempt ``n`` (1-based) failing
    sleeps ``min(max_delay, base_delay * 2**(n-1))`` scaled down by up
    to ``jitter`` (full-jitter style: a fleet of retriers must not
    re-dogpile the apiserver in lockstep). ``deadline`` caps the whole
    call's wall budget (0 = unbounded); ``attempt_timeout`` is the
    per-attempt budget hint callers pass to their transport (0 = use
    the transport's own default)."""

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
    """Executes callables under one RetryPolicy, with optional circuit
    integration: every attempt consults ``circuit`` first (an open
    circuit raises :class:`CircuitOpenError` without calling the
    target) and reports its outcome back to the breaker."""

    def __init__(
        self,
        policy: RetryPolicy,
        name: str,
        retryable: Callable[[BaseException], bool] = _default_retryable,
        circuit: Optional["CircuitBreaker"] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        journal=None,
    ) -> None:
        self.policy = policy
        self.name = name
        self.stats = RetryStats()
        self._retryable = retryable
        self._circuit = circuit
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
            if self._circuit is not None:
                self._circuit.before_call()  # CircuitOpenError when open
            try:
                out = fn()
            except CircuitOpenError:
                # the breaker tripped between before_call and a nested
                # guard: not a target failure, never retried here
                self.last_attempts = attempt
                self.stats.note(attempt, exhausted=False)
                raise
            except BaseException as e:
                retryable = self._retryable(e)
                if self._circuit is not None:
                    if not isinstance(e, Exception):
                        # interrupted, not answered: release any
                        # half-open probe slot without judging
                        self._circuit.abort_probe()
                    elif retryable:
                        self._circuit.on_failure()
                    else:
                        # a non-transient answer (404/409/429-shaped)
                        # means the dependency is HEALTHY — it must
                        # not trip the breaker into degraded mode
                        self._circuit.on_success()
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
            if self._circuit is not None:
                self._circuit.on_success()
            self.last_attempts = attempt
            self.stats.note(attempt, exhausted=False)
            return out


class CircuitOpenError(RuntimeError):
    """Raised by a breaker guard while the circuit is open: the caller
    fails fast instead of stacking timeouts onto a dead dependency."""


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    Closed -> ``failure_threshold`` consecutive failures -> open.
    Open   -> after ``reset_seconds`` -> half-open, admitting up to
    ``half_open_probes`` in-flight probe calls. A probe success closes
    the circuit (and resets the failure count); a probe failure
    re-opens it for another ``reset_seconds``.

    ``failure_threshold=0`` disables the breaker entirely (every guard
    is a no-op) — the config default, preserving legacy behavior.
    Transitions are journaled as ``CircuitOpen`` / ``CircuitClosed``.
    """

    def __init__(self, failure_threshold: int, reset_seconds: float,
                 name: str, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 journal=None) -> None:
        self.failure_threshold = failure_threshold
        self.reset_seconds = reset_seconds
        self.half_open_probes = max(1, half_open_probes)
        self.name = name
        self.journal = journal
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0       # consecutive, while closed
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.opens = 0           # cumulative trips (metrics)

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    def state_code(self) -> int:
        """0 closed / 1 half-open / 2 open (the metrics gauge)."""
        return _STATE_CODE[self.state()]

    def is_open(self) -> bool:
        """True only while calls are being refused (open, before the
        reset window elapses) — the degraded-mode gate."""
        return self.state() == OPEN

    def _effective_state_locked(self) -> str:
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_seconds):
            self._state = HALF_OPEN
            self._probes_in_flight = 0
        return self._state

    def _emit(self, reason: str, message: str, warning: bool) -> None:
        if self.journal is None:
            return
        try:
            self.journal.emit(
                reason, obj=f"circuit/{self.name}", message=message,
                type="Warning" if warning else "Normal",
            )
        except Exception:
            log.exception("event emit failed: %s", reason)

    def before_call(self) -> None:
        """Admission guard: raises CircuitOpenError while open; in
        half-open, admits only the probe budget."""
        if not self.enabled:
            return
        with self._lock:
            state = self._effective_state_locked()
            if state == CLOSED:
                return
            if state == HALF_OPEN:
                if self._probes_in_flight < self.half_open_probes:
                    self._probes_in_flight += 1
                    return
                raise CircuitOpenError(
                    f"circuit {self.name}: half-open, probe budget "
                    f"({self.half_open_probes}) in flight"
                )
            remaining = self.reset_seconds - (
                self._clock() - self._opened_at
            )
            raise CircuitOpenError(
                f"circuit {self.name}: open for another "
                f"{max(0.0, remaining):.1f}s"
            )

    def abort_probe(self) -> None:
        """Release a half-open probe slot without judging the outcome
        (the probed call was interrupted — KeyboardInterrupt, nested
        open circuit — not answered). Without this, an aborted probe
        would pin the breaker half-open with its budget consumed
        forever."""
        if not self.enabled:
            return
        with self._lock:
            if (self._effective_state_locked() == HALF_OPEN
                    and self._probes_in_flight > 0):
                self._probes_in_flight -= 1

    def on_success(self) -> None:
        if not self.enabled:
            return
        closed_now = False
        with self._lock:
            state = self._effective_state_locked()
            if state == HALF_OPEN:
                self._state = CLOSED
                self._probes_in_flight = 0
                closed_now = True
            self._failures = 0
        if closed_now:
            log.warning("circuit %s: probe succeeded; closed", self.name)
            self._emit("CircuitClosed",
                       "half-open probe succeeded; traffic restored",
                       warning=False)

    def on_failure(self) -> None:
        if not self.enabled:
            return
        opened_now = False
        with self._lock:
            state = self._effective_state_locked()
            if state == HALF_OPEN:
                # the probe failed: re-open for a fresh reset window
                self._state = OPEN
                self._opened_at = self._clock()
                self._probes_in_flight = 0
                self.opens += 1
                opened_now = True
            elif state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._state = OPEN
                    self._opened_at = self._clock()
                    self.opens += 1
                    opened_now = True
        if opened_now:
            log.error("circuit %s: opened (threshold %d); failing fast "
                      "for %.1fs", self.name, self.failure_threshold,
                      self.reset_seconds)
            self._emit(
                "CircuitOpen",
                f"tripped after {self.failure_threshold} consecutive "
                f"failure(s); failing fast for {self.reset_seconds:g}s",
                warning=True,
            )

    def call(self, fn: Callable[[], Any]) -> Any:
        """Guarded single call (no retries): admission, then outcome
        bookkeeping."""
        self.before_call()
        try:
            out = fn()
        except CircuitOpenError:
            # raised by a NESTED guard: our own admitted slot (possibly
            # a probe) was never answered — release it
            self.abort_probe()
            raise
        except Exception:
            self.on_failure()
            raise
        except BaseException:
            self.abort_probe()
            raise
        self.on_success()
        return out
