"""Configuration of the port's node agent and scheduler extender.

Its own copy of the fields of ``tpukube/core/config.py`` that the device
manager, the device plugin and the extender's default path read, with
the same names, the same ``TPUKUBE_<FIELD>`` environment overlay and the
same defaults, and no YAML file (the machines the port runs on have no YAML parser). The
default backend is ``"real"`` (NVML): a node agent runs against its GPUs
unless asked for the sim.

The reference's opt-in planes are not ported yet: a config that turns one
on is refused by :func:`load_config` rather than silently ignored.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace
from typing import Mapping, Optional

from tpukube_torch.core.mesh import MeshSpec

# One H100 SXM5: 80 GB of HBM3, 132 SMs; eight of them to an HGX node.
DEFAULT_HBM_BYTES = 80 * 1024**3
DEFAULT_SMS = 132

ENV_PREFIX = "TPUKUBE_"


@dataclass(frozen=True)
class GpuKubeConfig:
    # resources: a node advertises whole GPUs or shares of them, never both
    resource_tpu: str = "qiniu.com/tpu"
    resource_vtpu: str = "qiniu.com/vtpu"
    shares_per_chip: int = 1  # >1 mints vGPU shares (e.g. 2 or 4)
    # the ICI-domain name of the reference; here the NVLink domain
    slice_id: str = "slice-0"
    backend: str = "real"  # real (NVML) | sim
    # explicit libnvidia-ml path for the real backend; empty = the loader's
    # libnvidia-ml.so.1
    nvml_path: str = ""
    # real-backend health watch: "" = the native default (xid), or
    # xid|liveness|off — see native/gpuinfo.h gpuinfo_probe
    probe_mode: str = ""
    # sim topology (used when backend == "sim")
    sim_mesh_dims: tuple[int, int, int] = (8, 1, 1)
    sim_host_block: tuple[int, int, int] = (8, 1, 1)
    sim_torus: tuple[bool, bool, bool] = (False, False, False)
    # chip-coord origin of this host's block ("x,y,z"); empty = derive it
    # from the host name's host-i-j-k convention
    sim_host_origin: str = ""
    hbm_bytes_per_chip: int = DEFAULT_HBM_BYTES
    cores_per_chip: int = DEFAULT_SMS

    # node agent / device plugin (deviceplugin/v1beta1 over unix sockets)
    device_plugin_dir: str = "/var/lib/kubelet/device-plugins"
    kubelet_socket: str = "kubelet.sock"  # within device_plugin_dir
    plugin_socket: str = "tpukube.sock"  # within device_plugin_dir
    health_poll_seconds: float = 5.0

    # the retry policy (core/retry.py) of the seams a Retrier is wired
    # into: the plugin's kubelet registration
    retry_max_attempts: int = 5
    retry_base_delay_seconds: float = 0.1
    retry_max_delay_seconds: float = 5.0
    retry_jitter: float = 0.5  # fraction of each delay randomized away
    retry_deadline_seconds: float = 30.0  # overall wall budget (0 = none)
    # per-attempt transport-timeout cap (0 = the transport's own default)
    retry_attempt_timeout_seconds: float = 0.0

    # scheduler extender
    extender_host: str = "0.0.0.0"
    extender_port: int = 12345
    score_mode: str = "topology"  # topology | binpack | spread
    reservation_ttl_seconds: float = 30.0
    # decision trace: in-memory ring size (0 disables) and an optional
    # JSONL sink, rotated once at trace_sink_max_bytes (0 = unlimited)
    trace_capacity: int = 4096
    trace_path: str = ""
    trace_sink_max_bytes: int = 256 * 1024**2
    # structured event journal (obs/events.py); capacity 0 disables
    events_capacity: int = 4096
    events_path: str = ""
    events_sink_max_bytes: int = 64 * 1024**2
    # snapshot audit sentinel: on this fraction of scheduling-path cache
    # hits, rebuild the snapshot from the ledger and raise on divergence
    snapshot_audit_rate: float = 0.0
    # incremental snapshot maintenance (O(delta) advance per epoch)
    snapshot_delta_enabled: bool = True
    # batched node upserts with lazy decode on first touch
    bulk_ingest_enabled: bool = True

    # The reference's opt-in planes, not ported yet: load_config refuses
    # a config that turns one on.
    journal_enabled: bool = False
    batch_enabled: bool = False
    filter_from_plan: bool = False
    planner_replicas: int = 1
    shard_transport: str = "inprocess"
    decisions_enabled: bool = False
    capacity_enabled: bool = False
    tenancy_enabled: bool = False
    drain_enabled: bool = False
    autoscale_enabled: bool = False
    lock_monitor: bool = False

    def sim_mesh(self) -> MeshSpec:
        return MeshSpec(
            dims=self.sim_mesh_dims,
            host_block=self.sim_host_block,
            torus=self.sim_torus,
        )

    def plugin_socket_path(self) -> str:
        return os.path.join(self.device_plugin_dir, self.plugin_socket)

    def kubelet_socket_path(self) -> str:
        return os.path.join(self.device_plugin_dir, self.kubelet_socket)


_TUPLE_FIELDS = {"sim_mesh_dims", "sim_host_block", "sim_torus"}

# opt-in field -> the plane it would turn on (refused until ported)
_NOT_PORTED = {
    "journal_enabled": "the durable journal",
    "batch_enabled": "the batch scheduling cycle",
    "filter_from_plan": "the batch scheduling cycle",
    "decisions_enabled": "decision provenance",
    "capacity_enabled": "capacity analytics",
    "tenancy_enabled": "the tenancy plane",
    "drain_enabled": "drain",
    "autoscale_enabled": "the autoscaler",
    "lock_monitor": "the lock-order monitor",
}
# the reference's alloc change log for incremental resync (on by default
# there, capacity 65536): its readers, the shard router and the
# apiserver resync, are not ported, so the port has no such field and
# refuses a positive capacity
_RESYNC_LOG_KEY = ENV_PREFIX + "GENERATION_LOG_CAPACITY"


def _coerce(name: str, raw: str, current):
    if name in _TUPLE_FIELDS:
        parts = [p for p in raw.replace("x", ",").split(",") if p != ""]
        if isinstance(current[0], bool):
            vals = tuple(p.lower() in ("1", "true", "yes") for p in parts)
        else:
            vals = tuple(int(p) for p in parts)
        if len(vals) != 3:
            raise ValueError(f"config {name}: need 3 values, got {vals!r}")
        return vals
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    return type(current)(raw)


def load_config(env: Optional[Mapping[str, str]] = None) -> GpuKubeConfig:
    """defaults < env (TPUKUBE_<UPPER_FIELD_NAME>)."""
    cfg = GpuKubeConfig()
    env = os.environ if env is None else env
    updates = {
        f_.name: _coerce(f_.name, env[ENV_PREFIX + f_.name.upper()],
                         getattr(cfg, f_.name))
        for f_ in fields(cfg)
        if ENV_PREFIX + f_.name.upper() in env
    }
    cfg = replace(cfg, **updates)
    if cfg.shares_per_chip < 1:
        raise ValueError("shares_per_chip must be >= 1")
    if cfg.backend not in ("sim", "real"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.probe_mode not in ("", "xid", "liveness", "off"):
        raise ValueError(f"unknown probe_mode {cfg.probe_mode!r}")
    if cfg.sim_host_origin:
        parts = cfg.sim_host_origin.split(",")
        if len(parts) != 3 or not all(p.strip().lstrip("-").isdigit() for p in parts):
            raise ValueError(
                f"sim_host_origin must be 'x,y,z', got {cfg.sim_host_origin!r}"
            )
    if not cfg.slice_id:
        raise ValueError("slice_id must be non-empty")
    if not 0 < cfg.extender_port < 65536:
        raise ValueError(f"extender_port {cfg.extender_port} out of range")
    if cfg.health_poll_seconds <= 0 or cfg.reservation_ttl_seconds <= 0:
        raise ValueError("poll/ttl intervals must be positive")
    if cfg.score_mode not in ("topology", "binpack", "spread"):
        raise ValueError(f"unknown score_mode {cfg.score_mode!r}")
    if (cfg.trace_sink_max_bytes < 0 or cfg.events_capacity < 0
            or cfg.events_sink_max_bytes < 0):
        raise ValueError(
            "trace_sink_max_bytes, events_capacity, and "
            "events_sink_max_bytes must be >= 0"
        )
    if cfg.retry_max_attempts < 1:
        raise ValueError("retry_max_attempts must be >= 1")
    if cfg.retry_base_delay_seconds <= 0 or cfg.retry_max_delay_seconds <= 0:
        raise ValueError("retry delays must be positive")
    if cfg.retry_max_delay_seconds < cfg.retry_base_delay_seconds:
        raise ValueError(
            "retry_max_delay_seconds must be >= retry_base_delay_seconds"
        )
    if not 0.0 <= cfg.retry_jitter < 1.0:
        raise ValueError("retry_jitter must be in [0, 1)")
    if cfg.retry_deadline_seconds < 0:
        raise ValueError("retry_deadline_seconds must be >= 0 (0 = none)")
    if cfg.retry_attempt_timeout_seconds < 0:
        raise ValueError(
            "retry_attempt_timeout_seconds must be >= 0 (0 = transport "
            "default)"
        )
    if not 0.0 <= cfg.snapshot_audit_rate <= 1.0:
        raise ValueError(
            "snapshot_audit_rate must be in [0, 1] (0 = audit off)"
        )
    for name, plane in _NOT_PORTED.items():
        if getattr(cfg, name):
            raise ValueError(f"{name}: {plane} is not ported yet")
    if int(env.get(_RESYNC_LOG_KEY, "0")) != 0:
        raise ValueError("generation_log_capacity: the incremental resync "
                         "log is not ported yet")
    if cfg.planner_replicas != 1 or cfg.shard_transport != "inprocess":
        raise ValueError(
            "planner_replicas/shard_transport: the shard router is not "
            "ported yet")
    return cfg
