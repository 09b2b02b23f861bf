"""Node-agent configuration of the port.

Its own copy of the device-manager fields of ``tpukube/core/config.py``
with the same ``TPUKUBE_<FIELD>`` environment overlay, and no YAML file
(the machines the port runs on have no YAML parser). The default backend
is ``"real"`` (NVML): a node agent runs against its GPUs unless asked for
the sim.
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

    def sim_mesh(self) -> MeshSpec:
        return MeshSpec(
            dims=self.sim_mesh_dims,
            host_block=self.sim_host_block,
            torus=self.sim_torus,
        )


_TUPLE_FIELDS = {"sim_mesh_dims", "sim_host_block", "sim_torus"}


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
    return cfg
