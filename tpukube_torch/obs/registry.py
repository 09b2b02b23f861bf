"""Metrics registry — the port's own copy of ``tpukube/obs/registry.py``:
Counter/Gauge/Summary/Histogram with label sets, rendered as Prometheus
text format (no prometheus_client dependency).

The rendering rules are the reference's, so a scrape of the port reads
like a scrape of the reference:

  * ``%.6g`` values, sorted labels, ``# TYPE`` lines, HELP lines only
    where a family opts in;
  * label values can carry arbitrary runtime text and are escaped;
  * metrics render in registration order, labeled children in creation
    order.

The reference's ``DECLARED_SERIES`` (its lint pass's name list) is not
ported: the port has no lint pass.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Iterable, Optional, Sequence

# the prometheus_client defaults: request-latency-shaped, which is what
# both gang-commit and webhook latencies are
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

def quantile(values: Iterable[float], q: float) -> float:
    """Nearest-rank quantile; 0.0 on empty input."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = min(len(vs) - 1, max(0, round(q * (len(vs) - 1))))
    return vs[idx]


def escape_label_value(value) -> str:
    """Prometheus text-format label-value escaping. An unescaped quote or
    newline would corrupt the whole scrape — on exactly the degraded
    nodes the metric exists to flag."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help_text(text: str) -> str:
    """# HELP docstring escaping (backslash and newline only, per the
    exposition-format spec — quotes are legal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_sample(name: str, value: float,
                  labels: Optional[dict[str, str]] = None) -> str:
    """One exposition line, identical to the legacy ``_fmt``."""
    if labels:
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{inner}}} {value:.6g}\n"
    return f"{name} {value:.6g}\n"


def _bucket_label(bound: float) -> str:
    return "+Inf" if bound == float("inf") else f"{bound:g}"


class Metric:
    """Base: a named family with a ``# TYPE`` line and samples.

    ``emit_type=False`` suppresses the TYPE line (the reference's legacy
    quirk: ``tpukube_plugin_resource_info`` rides under the previous
    family's header, and the page keeps that byte for byte).

    ``help_text`` opts a family into a ``# HELP`` line before its TYPE.
    Off by default: the pre-registry renderers never emitted HELP and
    the byte-identical goldens must survive; new telemetry/event series
    pass it explicitly.
    """

    kind = "untyped"

    def __init__(self, name: str, emit_type: bool = True,
                 help_text: Optional[str] = None):
        self.name = name
        self.emit_type = emit_type
        self.help_text = help_text
        self._lock = threading.Lock()

    def samples(self) -> list[tuple[str, Optional[dict[str, str]], float]]:
        raise NotImplementedError

    def render(self) -> str:
        out = []
        if self.help_text:
            out.append(f"# HELP {self.name} "
                       f"{escape_help_text(self.help_text)}\n")
        if self.emit_type:
            out.append(f"# TYPE {self.name} {self.kind}\n")
        for name, labels, value in self.samples():
            out.append(format_sample(name, value, labels))
        return "".join(out)


class _ValueChild:
    """One (metric, label set) time series: a stored value or a pull
    callback evaluated at render time."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def get(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class _LabeledMetric(Metric):
    """Shared child bookkeeping for Counter/Gauge: ``labels(**kv)``
    returns the per-label-set series, created on first use and emitted
    in creation order."""

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None,
                 emit_type: bool = True, help_text: Optional[str] = None):
        super().__init__(name, emit_type=emit_type, help_text=help_text)
        self._self_child = _ValueChild(fn)
        # label-tuple -> child, insertion-ordered (emission order)
        self._children: dict[tuple[tuple[str, str], ...], _ValueChild] = {}
        self._has_unlabeled = fn is not None

    def labels(self, **labelset: str) -> _ValueChild:
        key = tuple(sorted((k, str(v)) for k, v in labelset.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _ValueChild()
            return child

    # unlabeled convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._has_unlabeled = True
        self._self_child.inc(amount)

    def set(self, value: float) -> None:
        self._has_unlabeled = True
        self._self_child.set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._has_unlabeled = True
        self._self_child.set_function(fn)

    def samples(self):
        out = []
        with self._lock:
            children = list(self._children.items())
        if self._has_unlabeled or not children:
            out.append((self.name, None, self._self_child.get()))
        for key, child in children:
            out.append((self.name, dict(key), child.get()))
        return out


class Counter(_LabeledMetric):
    kind = "counter"

    def set(self, value: float) -> None:  # counters only go up by contract
        raise TypeError("Counter has no set(); use inc() or set_function()")


class Gauge(_LabeledMetric):
    kind = "gauge"


class _DistChild:
    """Observation store shared by Summary and Histogram children: either
    an explicit observation list (``observe``) or a pull callback
    returning the current value window (``values_fn`` — how the
    renderers wrap the daemons' bounded latency deques)."""

    __slots__ = ("_lock", "_values", "_fn")

    def __init__(self, values_fn: Optional[Callable[[], Iterable[float]]] = None):
        self._lock = threading.Lock()
        self._values: list[float] = []
        self._fn = values_fn

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    def values(self) -> list[float]:
        if self._fn is not None:
            return [float(v) for v in self._fn()]
        with self._lock:
            return list(self._values)


class _DistMetric(Metric):
    """Shared child bookkeeping for Summary/Histogram."""

    def __init__(self, name: str,
                 values_fn: Optional[Callable[[], Iterable[float]]] = None,
                 help_text: Optional[str] = None):
        super().__init__(name, help_text=help_text)
        self._self_child = _DistChild(values_fn)
        self._has_unlabeled = values_fn is not None
        self._children: dict[tuple[tuple[str, str], ...], _DistChild] = {}

    def labels(self, _values_fn=None, **labelset: str) -> _DistChild:
        key = tuple(sorted((k, str(v)) for k, v in labelset.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _DistChild(_values_fn)
            return child

    def observe(self, value: float) -> None:
        self._has_unlabeled = True
        self._self_child.observe(value)

    def _series(self) -> list[tuple[Optional[dict[str, str]], _DistChild]]:
        out: list[tuple[Optional[dict[str, str]], _DistChild]] = []
        with self._lock:
            children = list(self._children.items())
        if self._has_unlabeled or not children:
            out.append((None, self._self_child))
        for key, child in children:
            out.append((dict(key), child))
        return out


class Summary(_DistMetric):
    """Quantile summary, matching the legacy renderers' shape: one
    ``name{quantile=...}`` line per configured quantile (nearest-rank
    over the current window) plus optional ``_count``/``_sum``."""

    kind = "summary"

    def __init__(self, name: str,
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99),
                 values_fn: Optional[Callable[[], Iterable[float]]] = None,
                 emit_count_sum: bool = True,
                 help_text: Optional[str] = None):
        super().__init__(name, values_fn=values_fn, help_text=help_text)
        self.quantiles = tuple(quantiles)
        self.emit_count_sum = emit_count_sum

    def samples(self):
        out = []
        for labels, child in self._series():
            vs = child.values()
            for q in self.quantiles:
                labelset = dict(labels or {})
                labelset["quantile"] = str(q)
                out.append((self.name, labelset, quantile(vs, q)))
            if self.emit_count_sum:
                out.append((f"{self.name}_count", labels, len(vs)))
                out.append((f"{self.name}_sum", labels, sum(vs)))
        return out


class _HistChild:
    """One histogram series: monotonic cumulative state updated at
    ``observe()`` time. Prometheus counters (and ``_bucket`` series ARE
    counters) must never decrease between scrapes — a snapshot of a
    bounded window deque would, the moment the window evicts, and every
    ``rate()``/``histogram_quantile()`` over the series would read the
    dip as a counter reset. So observations fold into per-bucket counts
    immediately (O(len(buckets)) memory, daemon-safe) and the raw values
    are never retained."""

    __slots__ = ("_lock", "_finite", "_counts", "_count", "_sum")

    def __init__(self, finite_bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self._finite = finite_bounds
        self._counts = [0] * (len(finite_bounds) + 1)  # + the +Inf bucket
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect_left(self._finite, v)] += 1
            self._count += 1
            self._sum += v

    def snapshot(self) -> tuple[list[int], int, float]:
        """(cumulative count per bucket incl. +Inf, total count, sum)."""
        with self._lock:
            counts, count, total = list(self._counts), self._count, self._sum
        cum, c = [], 0
        for n in counts:
            c += n
            cum.append(c)
        return cum, count, total


class Histogram(Metric):
    """Cumulative-bucket histogram: ``name_bucket{le=...}`` series with a
    ``+Inf`` terminal bucket, plus ``_count``/``_sum``. Observation-only
    (no pull callback): bucket series are counters, and a counter fed
    from a sliding-window snapshot would decrease — see
    :class:`_HistChild`.

    ``bucket_only=True`` pairs the histogram with a pre-existing legacy
    summary of the same family name: only the ``_bucket`` series render
    (typed as their own counter family), so the summary's
    ``_count``/``_sum`` lines are not duplicated and the legacy output
    stays byte-identical.
    """

    kind = "histogram"

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 bucket_only: bool = False,
                 help_text: Optional[str] = None):
        super().__init__(name, help_text=help_text)
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != float("inf"):
            bs.append(float("inf"))
        self.buckets = tuple(bs)
        self.bucket_only = bucket_only
        self._self_child = _HistChild(self.buckets[:-1])
        self._has_unlabeled = False
        self._children: dict[tuple[tuple[str, str], ...], _HistChild] = {}

    def labels(self, **labelset: str) -> _HistChild:
        key = tuple(sorted((k, str(v)) for k, v in labelset.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _HistChild(self.buckets[:-1])
            return child

    def observe(self, value: float) -> None:
        self._has_unlabeled = True
        self._self_child.observe(value)

    def _series(self) -> list[tuple[Optional[dict[str, str]], _HistChild]]:
        out: list[tuple[Optional[dict[str, str]], _HistChild]] = []
        with self._lock:
            children = list(self._children.items())
        if self._has_unlabeled or not children:
            out.append((None, self._self_child))
        for key, child in children:
            out.append((dict(key), child))
        return out

    def render(self) -> str:
        out = []
        # bucket_only: the family proper is already TYPEd (legacy
        # summary); the bucket series get their own counter family
        # header, so HELP must name that family too
        family = f"{self.name}_bucket" if self.bucket_only else self.name
        if self.help_text:
            out.append(f"# HELP {family} "
                       f"{escape_help_text(self.help_text)}\n")
        kind = "counter" if self.bucket_only else self.kind
        out.append(f"# TYPE {family} {kind}\n")
        for name, labels, value in self.samples():
            out.append(format_sample(name, value, labels))
        return "".join(out)

    def bucket_counts(self, values: Iterable[float]) -> list[int]:
        """Cumulative count per bucket boundary (last = total)."""
        finite = self.buckets[:-1]
        counts = [0] * len(self.buckets)
        total = 0
        for v in values:
            total += 1
            counts[bisect_left(finite, v)] += 1
        cum = 0
        out = []
        for c in counts:
            cum += c
            out.append(cum)
        assert out[-1] == total
        return out

    def samples(self):
        out = []
        for labels, child in self._series():
            cum, count, total = child.snapshot()
            for bound, c in zip(self.buckets, cum):
                labelset = dict(labels or {})
                labelset["le"] = _bucket_label(bound)
                out.append((f"{self.name}_bucket", labelset, c))
            if not self.bucket_only:
                out.append((f"{self.name}_count", labels, count))
                out.append((f"{self.name}_sum", labels, total))
        return out


class Registry:
    """An ordered collection of metrics rendering as one exposition page.

    Registration order IS emission order — the renderers rely on that to
    keep the legacy output byte-identical.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: list[Metric] = []

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            for m in self._metrics:
                if m.name == metric.name and type(m) is type(metric):
                    raise ValueError(
                        f"duplicate {type(metric).__name__} {metric.name!r}"
                    )
            self._metrics.append(metric)
        return metric

    # one-line constructors (register + return, for fluent renderer code)
    def counter(self, name: str, **kw) -> Counter:
        return self.register(Counter(name, **kw))  # type: ignore[return-value]

    def gauge(self, name: str, **kw) -> Gauge:
        return self.register(Gauge(name, **kw))  # type: ignore[return-value]

    def summary(self, name: str, **kw) -> Summary:
        return self.register(Summary(name, **kw))  # type: ignore[return-value]

    def histogram(self, name: str, **kw) -> Histogram:
        return self.register(Histogram(name, **kw))  # type: ignore[return-value]

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        return "".join(m.render() for m in metrics)
