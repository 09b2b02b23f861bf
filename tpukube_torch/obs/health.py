"""Per-GPU fleet health telemetry (node-agent side) — the port's own copy
of ``tpukube/obs/health.py``: the ``ChipTelemetry`` sample, with the same
fields, and the ``HealthSampler`` loop over it.

The device manager fills the sample (``GpuDeviceManager.telemetry_snapshot``):
the sim backend synthesizes occupancy and duty cycle as the reference
does, the real backend reads them from NVML (memory in use, GPU
utilization). The sampler polls it, keeps rolling windows, detects
state transitions (healthy, degraded = up but on a downed link,
unhealthy) and journals ChipUnhealthy/ChipRecovered/LinkFault/
LinkRecovered; ``/metrics`` reads it through
``tpukube_torch.metrics.render_plugin_metrics``.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from tpukube_torch.core.types import Health, TopologyCoord

log = logging.getLogger("tpukube_torch.obs.health")

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_UNHEALTHY = "unhealthy"


@dataclass(frozen=True)
class ChipTelemetry:
    """One GPU's sample: identity, instantaneous gauges and cumulative
    counters, as read from the device layer at one poll."""

    device_id: str
    index: int
    coord: TopologyCoord
    health: Health
    hbm_total_bytes: int
    hbm_used_bytes: int
    duty_cycle_percent: float  # NVML GPU utilization on the real backend
    ici_link_errors: int  # cumulative counter (the sim's downed links)
    links_down: int  # downed links touching this GPU right now

    @property
    def state(self) -> str:
        if self.health is not Health.HEALTHY:
            return STATE_UNHEALTHY
        if self.links_down:
            return STATE_DEGRADED
        return STATE_HEALTHY


class HealthSampler:
    """Polls device telemetry, keeps rolling windows, detects
    transitions, emits journal events.

    Same deterministic-step shape as the other daemon loops
    (start/stop/check_once); ``check_once`` is what tests and the sim
    drive directly. The /metrics registry reads it through pull
    callbacks over ``latest``/counters; ``telemetry_status`` is the
    node agent's status document section.
    """

    WINDOW = 32  # samples per chip kept for rolling stats

    def __init__(self, device, poll_seconds: Optional[float] = None,
                 journal=None, on_transition=None):
        self._device = device
        if poll_seconds is None:
            poll_seconds = device._config.health_poll_seconds
        self._poll = poll_seconds
        self._journal = journal
        # called (no args) after any state transition — the daemon hooks
        # its annotation rewrite here, same contract as HealthWatcher
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._latest: dict[str, ChipTelemetry] = {}
        self._states: dict[str, str] = {}
        # device id -> deque[(duty, hbm_used)] rolling window
        self._windows: dict[str, deque] = {}
        self._transition_counts: dict[str, int] = {}
        self.samples = 0       # polls taken (metrics/tests)
        self.transitions = 0   # chip-state flips observed

    # -- loop --------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("health sampler already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpukube-telemetry")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.check_once()
            except Exception:
                log.exception("telemetry poll failed")

    def _emit(self, reason: str, obj: str, message: str,
              warning: bool = True) -> None:
        if self._journal is None:
            return
        try:
            self._journal.emit(
                reason, obj=obj, message=message,
                type="Warning" if warning else "Normal",
                node=self._device.host,
            )
        except Exception:
            log.exception("event emit failed for %s %s", reason, obj)

    def check_once(self) -> bool:
        """One telemetry poll; True if any chip changed state."""
        samples = self._device.telemetry_snapshot()
        transitioned = False
        with self._lock:
            self.samples += 1
            for t in samples:
                self._latest[t.device_id] = t
                w = self._windows.get(t.device_id)
                if w is None:
                    w = self._windows[t.device_id] = deque(maxlen=self.WINDOW)
                w.append((t.duty_cycle_percent, t.hbm_used_bytes))
                prev = self._states.get(t.device_id)
                state = t.state
                if prev == state:
                    continue
                self._states[t.device_id] = state
                if prev is None:
                    continue  # first sighting is a baseline, not a flip
                transitioned = True
                self.transitions += 1
                self._transition_counts[t.device_id] = (
                    self._transition_counts.get(t.device_id, 0) + 1
                )
                obj = f"chip/{t.device_id}"
                if state == STATE_UNHEALTHY:
                    self._emit("ChipUnhealthy", obj,
                               f"chip at {tuple(t.coord)} went unhealthy")
                elif prev == STATE_UNHEALTHY:
                    self._emit("ChipRecovered", obj,
                               f"chip at {tuple(t.coord)} recovered",
                               warning=False)
                elif state == STATE_DEGRADED:
                    self._emit("LinkFault", obj,
                               f"{t.links_down} downed link(s) at "
                               f"{tuple(t.coord)}")
                else:  # degraded -> healthy
                    self._emit("LinkRecovered", obj,
                               f"links at {tuple(t.coord)} restored",
                               warning=False)
        if transitioned and self._on_transition is not None:
            try:
                self._on_transition()
            except Exception:
                log.exception("telemetry transition hook failed")
        return transitioned

    # -- read side ---------------------------------------------------------
    def latest(self) -> list[ChipTelemetry]:
        """Most recent sample per chip, index order — the /metrics pull
        surface."""
        with self._lock:
            return sorted(self._latest.values(), key=lambda t: t.index)

    def sample(self, device_id: str) -> Optional[ChipTelemetry]:
        """Most recent sample for one chip (the registry's pull
        callbacks close over this)."""
        with self._lock:
            return self._latest.get(device_id)

    def state_counts(self) -> dict[str, int]:
        with self._lock:
            out = {STATE_HEALTHY: 0, STATE_DEGRADED: 0, STATE_UNHEALTHY: 0}
            for s in self._states.values():
                out[s] = out.get(s, 0) + 1
            return out

    def transition_count(self, device_id: str) -> int:
        with self._lock:
            return self._transition_counts.get(device_id, 0)

    def telemetry_status(self) -> dict[str, Any]:
        """The node agent's /statusz telemetry section: per-chip state +
        latest sample + rolling-window means."""
        with self._lock:
            chips = []
            for did in sorted(self._latest, key=lambda d: self._latest[d].index):
                t = self._latest[did]
                w = self._windows.get(did) or ()
                n = len(w) or 1
                chips.append({
                    "device": did,
                    "coord": list(t.coord),
                    "state": self._states.get(did, STATE_HEALTHY),
                    "duty_cycle_percent": t.duty_cycle_percent,
                    "duty_cycle_avg_percent": round(
                        sum(d for d, _ in w) / n, 2),
                    "hbm_used_bytes": t.hbm_used_bytes,
                    "hbm_total_bytes": t.hbm_total_bytes,
                    "ici_link_errors": t.ici_link_errors,
                    "transitions": self._transition_counts.get(did, 0),
                })
            states = {STATE_HEALTHY: 0, STATE_DEGRADED: 0,
                      STATE_UNHEALTHY: 0}
            for s in self._states.values():
                states[s] = states.get(s, 0) + 1
            return {
                "samples": self.samples,
                "window": self.WINDOW,
                "transitions": self.transitions,
                "states": states,
                "chips": chips,
            }
