"""SLOs and burn-rate math over the /metrics histograms — the port's own
copy of ``tpukube/obs/slo.py``.

The latency distributions render as monotonic ``_bucket`` counters; this
module turns them into service-level objectives: "99% of gang commits
land within 2.5s", "99.9% of bind webhooks answer within 250ms". The
burn rate is the standard SRE quantity — observed error ratio divided
by the error budget (1 - objective) — so burn 1.0 spends the budget
exactly at the SLO window's natural pace, burn 14.4 exhausts a 30-day
budget in ~2 days. ``deploy/prometheus-rules.yaml`` encodes the same
SLOs as multi-window burn-rate recording and alerting rules for a real
Prometheus; ``python -m tpukube_torch.cli obs slo`` evaluates them
offline from a live /metrics endpoint or a captured snapshot (lifetime
burn from one snapshot, windowed burn from two). The tenancy plane's
``BurnMonitor`` (``tenancy/core.py``) reads ``DEFAULT_SLOS`` and
``burn_rate`` from here.

This module also owns the exposition-format PARSER and the lint
validator the format tests run over the daemons' /metrics — the SLO
evaluator and the linter must agree on what a series is, so they share
one parser.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Iterable, Optional

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\d+)?$"
)
_LABEL_RE = re.compile(
    r'\s*(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


@dataclass(frozen=True)
class Sample:
    name: str
    labels: tuple[tuple[str, str], ...]
    value: float

    def label(self, key: str, default: str = "") -> str:
        for k, v in self.labels:
            if k == key:
                return v
        return default


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _parse_labels(raw: Optional[str]) -> Optional[tuple]:
    """label tuple, or None on malformed label syntax."""
    if raw is None:
        return ()
    out = []
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            return None
        out.append((m.group("key"), _unescape(m.group("val"))))
        pos = m.end()
    return tuple(out)


def parse_metrics(text: str) -> list[Sample]:
    """Every sample line of an exposition page (comments skipped;
    malformed lines raise — a scrape either parses or it doesn't)."""
    out = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparsable sample: {line!r}")
        labels = _parse_labels(m.group("labels"))
        if labels is None:
            raise ValueError(f"line {lineno}: bad label syntax: {line!r}")
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value: {line!r}") from e
        out.append(Sample(m.group("name"), labels, value))
    return out


# -- exposition lint (the tier-1 format test) --------------------------------

def validate_exposition(text: str) -> list[str]:
    """Prometheus text-format lint: returns a list of violations (empty
    = clean). Checks the properties every series addition must keep:

      * every line parses (names, label syntax/escaping, float values);
      * at most one ``# TYPE`` per family, placed before that family's
        first sample;
      * no duplicate (name, label set) series;
      * a family's samples are contiguous (no other family's TYPE'd
        samples interleaved — untyped singleton lines are legal, which
        is the documented ``tpukube_plugin_resource_info`` quirk);
      * histogram ``_bucket`` samples carry an ``le`` label, summary
        quantile lines a ``quantile`` label.
    """
    errors: list[str] = []
    types: dict[str, str] = {}          # family -> kind
    type_declared_at: dict[str, int] = {}
    first_sample_at: dict[str, int] = {}
    last_family: Optional[str] = None
    closed: set[str] = set()            # families whose block ended
    seen: set[tuple[str, tuple]] = set()

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_count", "_sum"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                # suffix of a TYPE'd family — unless the suffixed name
                # is itself a TYPE'd family (bucket_only histograms)
                if name not in types:
                    return name[: -len(suffix)]
        return name

    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 4)
            if len(parts) < 4:
                errors.append(f"line {lineno}: malformed TYPE line")
                continue
            fam, kind = parts[2], parts[3]
            if fam in types:
                errors.append(f"line {lineno}: duplicate TYPE for {fam}")
            if fam in first_sample_at:
                errors.append(
                    f"line {lineno}: TYPE for {fam} after its samples "
                    f"(line {first_sample_at[fam]})"
                )
            types[fam] = kind
            type_declared_at[fam] = lineno
            continue
        if line.startswith("#"):
            continue  # HELP / comments: free-form
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {lineno}: unparsable sample: {line!r}")
            continue
        name = m.group("name")
        labels = _parse_labels(m.group("labels"))
        if labels is None:
            errors.append(f"line {lineno}: bad label syntax: {line!r}")
            continue
        try:
            float(m.group("value"))
        except ValueError:
            errors.append(f"line {lineno}: non-float value: {line!r}")
            continue
        key = (name, tuple(sorted(labels)))
        if key in seen:
            errors.append(f"line {lineno}: duplicate series {name}"
                          f"{dict(labels)}")
        seen.add(key)
        fam = family_of(name)
        first_sample_at.setdefault(fam, lineno)
        if fam != last_family:
            if last_family is not None:
                closed.add(last_family)
            if fam in closed and fam in types:
                errors.append(
                    f"line {lineno}: family {fam} re-opened after other "
                    f"families (samples must be grouped)"
                )
            last_family = fam
        kind = types.get(fam)
        label_keys = {k for k, _ in labels}
        if name.endswith("_bucket") and kind in ("histogram", "counter"):
            if "le" not in label_keys:
                errors.append(f"line {lineno}: {name} without an le label")
        if kind == "summary" and name == fam and "quantile" not in label_keys:
            errors.append(
                f"line {lineno}: summary {fam} sample without a quantile "
                f"label"
            )
    return errors


# -- SLO definitions ---------------------------------------------------------

@dataclass(frozen=True)
class SloSpec:
    """One latency SLO over a cumulative-bucket histogram family:
    ``objective`` of requests must land in the bucket at
    ``threshold_le`` (which must be a real boundary the registry
    renders — the rules test cross-checks that)."""

    name: str
    family: str           # e.g. "gang_schedule_latency_seconds"
    threshold_le: str     # bucket label, e.g. "2.5"
    objective: float      # e.g. 0.99
    labels: tuple[tuple[str, str], ...] = ()  # child filter (handler=...)
    description: str = ""

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


DEFAULT_SLOS: tuple[SloSpec, ...] = (
    SloSpec(
        name="gang-schedule-latency",
        family="gang_schedule_latency_seconds",
        threshold_le="2.5",
        objective=0.99,
        description="99% of gang commits assemble within 2.5s of the "
                    "slice reservation",
    ),
    SloSpec(
        name="bind-webhook-latency",
        family="tpukube_webhook_latency_seconds",
        threshold_le="0.25",
        objective=0.999,
        labels=(("handler", "bind"),),
        description="99.9% of /bind webhooks answer within 250ms",
    ),
)

# Multi-window multi-burn-rate alert policy (Google SRE workbook ch.5):
# page when the budget burns fast over BOTH a short and a long window
# (the short window makes the alert reset quickly once the burn stops).
MULTIWINDOW_ALERTS: tuple[dict[str, Any], ...] = (
    {"severity": "page", "long": "1h", "short": "5m", "burn": 14.4},
    {"severity": "ticket", "long": "6h", "short": "30m", "burn": 6.0},
)


def histogram_totals(
    samples: Iterable[Sample], family: str, threshold_le: str,
    labels: tuple[tuple[str, str], ...] = (),
) -> tuple[float, float]:
    """(good, total) over a bucket family: good = observations in the
    threshold bucket, total = the +Inf bucket, summed across every
    child matching the label filter."""
    want = dict(labels)
    good = total = 0.0
    for s in samples:
        if s.name != f"{family}_bucket":
            continue
        if any(s.label(k) != v for k, v in want.items()):
            continue
        le = s.label("le")
        if le == threshold_le:
            good += s.value
        elif le == "+Inf":
            total += s.value
    return good, total


def burn_rate(good: float, total: float, objective: float) -> Optional[float]:
    """Observed error ratio over the error budget; None with no
    traffic (no traffic is not a burning SLO)."""
    if total <= 0:
        return None
    error_ratio = 1.0 - good / total
    return round(error_ratio / (1.0 - objective), 6)


def evaluate(
    text: str, slos: Iterable[SloSpec] = DEFAULT_SLOS,
    prev_text: Optional[str] = None,
    window_seconds: Optional[float] = None,
) -> dict[str, Any]:
    """Evaluate SLOs against one exposition page (lifetime burn since
    process start) or a pair (windowed burn over the scrape interval —
    what ``obs slo --url --window`` does)."""
    samples = parse_metrics(text)
    prev = parse_metrics(prev_text) if prev_text is not None else None
    out: dict[str, Any] = {}
    for slo in slos:
        good, total = histogram_totals(
            samples, slo.family, slo.threshold_le, slo.labels
        )
        entry: dict[str, Any] = {
            "slo": slo.description or slo.name,
            "family": slo.family,
            "threshold_seconds": float(slo.threshold_le),
            "objective": slo.objective,
            "good": good,
            "total": total,
            "error_ratio": (round(1.0 - good / total, 6) if total else None),
            "burn_rate": burn_rate(good, total, slo.objective),
            "window": "lifetime",
        }
        if prev is not None:
            pgood, ptotal = histogram_totals(
                prev, slo.family, slo.threshold_le, slo.labels
            )
            dgood, dtotal = good - pgood, total - ptotal
            entry["window"] = (
                f"{window_seconds:g}s" if window_seconds else "delta"
            )
            entry["good"], entry["total"] = dgood, dtotal
            entry["error_ratio"] = (
                round(1.0 - dgood / dtotal, 6) if dtotal > 0 else None
            )
            entry["burn_rate"] = burn_rate(dgood, dtotal, slo.objective)
        br = entry["burn_rate"]
        entry["alerts"] = [
            a["severity"] for a in MULTIWINDOW_ALERTS
            if br is not None and br >= a["burn"]
        ]
        out[slo.name] = entry
    return out


def referenced_metric_names(expr: str) -> set[str]:
    """Base metric names a PromQL expression reads — identifiers that
    are not PromQL functions/keywords or recording-rule names (those
    contain ':'). The rules test cross-checks these against the series
    the registries actually render."""
    ignore = {
        "sum", "rate", "irate", "increase", "histogram_quantile", "by",
        "on", "ignoring", "group_left", "group_right", "avg", "max",
        "min", "count", "abs", "clamp_min", "clamp_max", "le", "and",
        "or", "unless", "without", "offset", "bool", "absent", "topk",
        "bottomk", "delta", "idelta", "changes", "time", "vector",
        "scalar", "label_replace", "Inf", "inf", "nan", "NaN", "m", "h",
        "s", "d",
    }
    out = set()
    # strip label matcher bodies and quoted strings first: their values
    # (handler="bind") are not metric names
    cleaned = re.sub(r'"(?:[^"\\]|\\.)*"', "", expr)
    cleaned = re.sub(r"\{[^}]*\}", "", cleaned)   # label matcher bodies
    cleaned = re.sub(r"\[[^\]]*\]", "", cleaned)  # range selectors [5m]
    # grouping clauses name LABELS, not metrics: by (handler, le)
    cleaned = re.sub(
        r"\b(?:by|on|ignoring|without|group_left|group_right)\s*"
        r"\([^)]*\)", "", cleaned,
    )
    for name in _NAME_RE.findall(cleaned):
        if ":" in name:
            continue  # recording rule
        if name in ignore:
            continue
        out.add(name)
    return out
