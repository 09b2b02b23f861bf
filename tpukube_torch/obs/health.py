"""Per-GPU telemetry sample — the port's own copy of ``ChipTelemetry``
from ``tpukube/obs/health.py``, with the same fields.

The device manager fills it (``GpuDeviceManager.telemetry_snapshot``):
the sim backend synthesizes occupancy and duty cycle as the reference
does, the real backend reads them from NVML (memory used, GPU
utilization). The sampler loop of the reference is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpukube_torch.core.types import Health, TopologyCoord

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
