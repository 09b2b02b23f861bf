"""GPU device manager (L2) — the port of ``tpukube/device/tpu.py``.

Discovers the node's GPUs through libgpuinfo (NVML, or the sim), mints the
device ids ``tpu-<i>`` (wire names, unchanged), and turns an Allocate into
container env. ``CUDA_VISIBLE_DEVICES`` takes the place of the reference's
``TPU_VISIBLE_DEVICES``, with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` so that CUDA's
index i is NVML's index i; every ``TPU_KUBE_*`` key and
``TPU_HBM_LIMIT_BYTES`` stays as it is, because the scheduler and the pods
read them by those names.

Whole-GPU mode only: fractional shares (MIG/MPS in place of the reference's
HBM fraction and TensorCore ids) are not ported yet, and a config that asks
for them is refused.
"""

from __future__ import annotations

import threading
from typing import Optional

from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import ChipInfo, Health, NodeInfo, parse_device_id
from tpukube_torch.native import GpuInfo, sim_spec

ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_DEVICE_ORDER = "CUDA_DEVICE_ORDER"
DEVICE_ORDER = "PCI_BUS_ID"  # NVML enumerates in PCI bus order
ENV_KUBE_DEVICE_IDS = "TPU_KUBE_DEVICE_IDS"
ENV_KUBE_CHIP_COORDS = "TPU_KUBE_CHIP_COORDS"
ENV_KUBE_MESH_DIMS = "TPU_KUBE_MESH_DIMS"
ENV_KUBE_HOST = "TPU_KUBE_HOST"
ENV_KUBE_SLICE = "TPU_KUBE_SLICE_ID"
# produced by the scheduler extender in the alloc annotation (the Allocate
# sees only device ids); named here so producer and consumer share them
ENV_GANG_NUM_SLICES = "TPU_KUBE_GANG_NUM_SLICES"
ENV_GANG_SLICES = "TPU_KUBE_GANG_SLICES"
ENV_GANG_SLICE_INDEX = "TPU_KUBE_GANG_SLICE_INDEX"
ENV_KUBE_TENANT = "TPU_KUBE_TENANT"
ENV_HBM_LIMIT = "TPU_HBM_LIMIT_BYTES"


class DeviceError(RuntimeError):
    pass


class GpuDeviceManager:
    """Owns the node's libgpuinfo session and all device-id minting."""

    def __init__(self, config: GpuKubeConfig, host: Optional[str] = None):
        if config.shares_per_chip > 1:
            raise DeviceError("vGPU sharing is not ported yet")
        self._config = config
        self._lock = threading.Lock()
        self._host = host or "host-0-0-0"
        if config.backend == "sim":
            origin = None
            if config.sim_host_origin:
                x, y, z = config.sim_host_origin.split(",")
                origin = (int(x), int(y), int(z))
            spec = sim_spec(
                config.sim_mesh(),
                self._host,
                config.hbm_bytes_per_chip,
                config.cores_per_chip,
                origin=origin,
            )
            self._gi = GpuInfo("sim", spec)
        else:
            spec = f"nvml={config.nvml_path}\n" if config.nvml_path else None
            self._gi = GpuInfo("real", spec)
        self._mesh = self._gi.mesh()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._gi.close()

    def __enter__(self) -> "GpuDeviceManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- discovery ---------------------------------------------------------
    @property
    def mesh(self) -> MeshSpec:
        return self._mesh

    @property
    def host(self) -> str:
        return self._host

    def chips(self) -> list[ChipInfo]:
        return self._gi.chips()

    def node_info(self) -> NodeInfo:
        chips = self.chips()
        mine = {c.coord for c in chips}
        # a node agent reports only the downed links it can see: those with
        # at least one endpoint on this host
        bad_links = [
            (a, b) for a, b in self._gi.link_faults()
            if a in mine or b in mine
        ]
        return NodeInfo(
            name=self._host,
            chips=chips,
            shares_per_chip=self._config.shares_per_chip,
            bad_links=bad_links,
            slice_id=self._config.slice_id,
            source=self._gi.source(),
        )

    def inventory_source(self) -> str:
        """Where the inventory came from: "sim" or "nvml"."""
        return self._gi.source()

    def probe(self) -> bool:
        """Run the backend's liveness probe (no-op True on sim); chips()
        and health_snapshot() reflect the outcome."""
        return self._gi.probe()

    def device_list(self) -> list[tuple[str, Health]]:
        """(device_id, health) pairs advertised on ListAndWatch."""
        return [(chip.device_id(), chip.health) for chip in self.chips()]

    def health_snapshot(self) -> dict[str, Health]:
        return dict(self.device_list())

    # -- allocation --------------------------------------------------------
    def allocate_env(self, device_ids: list[str]) -> dict[str, str]:
        """Build the container env for an Allocate of ``device_ids``."""
        with self._lock:
            if not device_ids:
                raise DeviceError("empty device list")
            by_index = {c.index: c for c in self.chips()}

            def chip_at(index: int) -> ChipInfo:
                if index not in by_index:
                    raise DeviceError(f"unknown chip index {index} on {self._host}")
                return by_index[index]

            chip_indices: list[int] = []
            hbm_limit = 0
            seen: set[str] = set()
            for did in device_ids:
                if did in seen:
                    raise DeviceError(f"duplicate device id {did}")
                seen.add(did)
                try:
                    index, frac = parse_device_id(did)
                except ValueError as e:
                    raise DeviceError(str(e)) from e
                chip = chip_at(index)
                if chip.health is not Health.HEALTHY:
                    raise DeviceError(f"device {did} is unhealthy")
                if frac is not None:
                    raise DeviceError(
                        f"{did}: node is in whole-chip mode; vTPU id rejected"
                    )
                hbm_limit += chip.hbm_bytes
                if index not in chip_indices:
                    chip_indices.append(index)

            chip_indices.sort()
            coords = [chip_at(i).coord for i in chip_indices]
            return {
                ENV_VISIBLE_DEVICES: ",".join(str(i) for i in chip_indices),
                ENV_DEVICE_ORDER: DEVICE_ORDER,
                ENV_KUBE_DEVICE_IDS: ",".join(sorted(seen)),
                ENV_KUBE_CHIP_COORDS: ";".join(
                    ",".join(str(v) for v in c) for c in coords
                ),
                ENV_KUBE_MESH_DIMS: ",".join(str(d) for d in self._mesh.dims),
                ENV_KUBE_HOST: self._host,
                ENV_KUBE_SLICE: self._config.slice_id,
                ENV_HBM_LIMIT: str(hbm_limit),
            }

    # -- health / faults (sim only) ---------------------------------------
    def inject_fault(self, chip_index: int, healthy: bool = False) -> None:
        """Sim-only: flip chip health (the NVML XID event analog)."""
        self._gi.inject_fault(chip_index, healthy)

    def inject_link_fault(self, a, b, up: bool = False) -> None:
        """Sim-only: drop (or restore) the link between adjacent coords."""
        self._gi.inject_link_fault(a, b, up)

    def link_faults(self) -> list:
        """Downed links visible to this session (canonical pairs)."""
        return self._gi.link_faults()
