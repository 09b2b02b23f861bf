"""GPU device manager (L2) — the port of ``tpukube/device/tpu.py``.

Discovers the node's GPUs through libgpuinfo (NVML, or the sim), mints the
device ids ``tpu-<i>`` (wire names, unchanged), and turns an Allocate into
container env. ``CUDA_VISIBLE_DEVICES`` takes the place of the reference's
``TPU_VISIBLE_DEVICES``, with ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` so that CUDA's
index i is NVML's index i; every ``TPU_KUBE_*`` key and
``TPU_HBM_LIMIT_BYTES`` stays as it is, because the scheduler and the pods
read them by those names.

Sharing policy, as in the reference: ``shares_per_chip`` is a node-level
mode switch. A node advertises whole GPUs (``qiniu.com/tpu``, ids
``tpu-<i>``) or shares of them (``qiniu.com/vtpu``, ids
``tpu-<i>-frac<k>of<n>``), never both. A share's env carries its memory
quota three ways: ``TPU_HBM_LIMIT_BYTES`` (what the quota guard,
``native/cudaguard.cpp``, enforces when preloaded), and the cooperative
``TPU_KUBE_MEM_FRACTION`` that the pod hands to
``torch.cuda.set_per_process_memory_fraction`` (the counterpart of
``XLA_PYTHON_CLIENT_MEM_FRACTION``, which PyTorch does not read). Its SMs
are ``TPU_KUBE_CORE_IDS``, in the reference's format, and
``CUDA_MPS_ACTIVE_THREAD_PERCENTAGE``, which binds only under an MPS
control daemon; like the reference's core split, it is cooperative.
"""

from __future__ import annotations

import threading
from typing import Optional

from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import (
    ChipInfo,
    Health,
    NodeInfo,
    TopologyCoord,
    VtpuShare,
    canonical_link,
    parse_device_id,
)
from tpukube_torch.native import GpuInfo, sim_spec
from tpukube_torch.obs.health import ChipTelemetry

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
# the cooperative cap of a share: the most constrained GPU's share fraction
ENV_MEM_FRACTION = "TPU_KUBE_MEM_FRACTION"
# a share's SMs: "gpu:smA+smB;gpu:sm" per allocated GPU, and the MPS
# client's share of SMs in percent
ENV_KUBE_CORE_IDS = "TPU_KUBE_CORE_IDS"
ENV_MPS_THREAD_PERCENTAGE = "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"


class DeviceError(RuntimeError):
    pass


class GpuDeviceManager:
    """Owns the node's libgpuinfo session and all device-id minting."""

    def __init__(self, config: GpuKubeConfig, host: Optional[str] = None):
        self._config = config
        self._lock = threading.Lock()
        self._host = host or "host-0-0-0"
        # telemetry state: the sim synthesis's tick and each GPU's
        # cumulative link-error counter
        self._telemetry_ticks = 0
        self._link_error_counts: dict[int, int] = {}
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
            spec = ""
            if config.nvml_path:
                spec += f"nvml={config.nvml_path}\n"
            if config.probe_mode:
                spec += f"probe={config.probe_mode}\n"
            self._gi = GpuInfo("real", spec or None)
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

    @property
    def resource_name(self) -> str:
        """The one extended resource this node advertises."""
        if self._config.shares_per_chip > 1:
            return self._config.resource_vtpu
        return self._config.resource_tpu

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
        """Run the backend's health probe (NVML XID events and liveness;
        no-op True on sim); chips() and health_snapshot() reflect the
        outcome."""
        return self._gi.probe()

    def probe_report(self) -> str:
        """What the last failed probe found."""
        return self._gi.last_error()

    def shares_of(self, chip: ChipInfo) -> list[VtpuShare]:
        n = self._config.shares_per_chip
        quota = chip.hbm_bytes // n
        return [VtpuShare(chip.index, k, n, quota) for k in range(n)]

    def device_list(self) -> list[tuple[str, Health]]:
        """(device_id, health) pairs advertised on ListAndWatch."""
        out: list[tuple[str, Health]] = []
        for chip in self.chips():
            if self._config.shares_per_chip > 1:
                out.extend((s.device_id(), chip.health) for s in self.shares_of(chip))
            else:
                out.append((chip.device_id(), chip.health))
        return out

    def health_snapshot(self) -> dict[str, Health]:
        return dict(self.device_list())

    # -- allocation --------------------------------------------------------
    def allocate_env(self, device_ids: list[str]) -> dict[str, str]:
        """Build the container env for an Allocate of ``device_ids``.

        Whole-GPU and share ids cannot mix (they are different resources;
        the kubelet never mixes them in one request)."""
        with self._lock:
            if not device_ids:
                raise DeviceError("empty device list")
            by_index = {c.index: c for c in self.chips()}

            def chip_at(index: int) -> ChipInfo:
                if index not in by_index:
                    raise DeviceError(f"unknown chip index {index} on {self._host}")
                return by_index[index]

            shares_mode = self._config.shares_per_chip > 1
            chip_indices: list[int] = []
            share_ks: dict[int, list[int]] = {}  # GPU index -> share ks
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
                if shares_mode:
                    if frac is None:
                        raise DeviceError(
                            f"{did}: node is in vTPU mode; whole-chip id rejected"
                        )
                    k, n = frac
                    if n != self._config.shares_per_chip or not 0 <= k < n:
                        raise DeviceError(f"{did}: share does not match node config")
                    hbm_limit += chip.hbm_bytes // n
                    share_ks.setdefault(index, []).append(k)
                else:
                    if frac is not None:
                        raise DeviceError(
                            f"{did}: node is in whole-chip mode; vTPU id rejected"
                        )
                    hbm_limit += chip.hbm_bytes
                if index not in chip_indices:
                    chip_indices.append(index)

            chip_indices.sort()
            coords = [chip_at(i).coord for i in chip_indices]
            env = {
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
            if shares_mode:
                env.update(self._share_env(chip_indices, share_ks, chip_at))
            return env

    def _share_env(self, chip_indices, share_ks, chip_at) -> dict[str, str]:
        """The cooperative caps of an allocation of shares: memory fraction
        and SMs of the most constrained GPU (the caps apply per device,
        and a pooled average would over-grant the GPU holding fewer
        shares)."""
        n = self._config.shares_per_chip
        min_shares = min(len(ks) for ks in share_ks.values())
        env = {ENV_MEM_FRACTION: f"{min_shares / n:.4f}"}
        # SM partition: when shares divide a GPU's SMs evenly, share k owns
        # SMs [k*cps, (k+1)*cps). With more shares than SMs nothing is
        # emitted (memory-only partitioning).
        parts, pct = [], 100
        for index in chip_indices:
            cores = chip_at(index).num_cores
            if cores % n != 0:
                return env
            cps = cores // n
            owned = sorted(
                c for k in share_ks[index] for c in range(k * cps, (k + 1) * cps)
            )
            parts.append(f"{index}:{'+'.join(map(str, owned))}")
            pct = min(pct, len(owned) * 100 // cores)
        env[ENV_KUBE_CORE_IDS] = ";".join(parts)
        env[ENV_MPS_THREAD_PERCENTAGE] = str(pct)
        return env

    def preferred_allocation(
        self,
        available: list[str],
        required: list[str],
        size: int,
    ) -> list[str]:
        """Pick ``size`` devices, growing a connected set greedily from the
        required ids: two shares of one GPU score 2, linked GPUs 1.

        Sim backend: linked means mesh neighbours over a link that is up, as
        in the reference. Real backend: the GPUs of one host are all to all
        (NVLink through NVSwitch), so any two GPUs are linked; PCIe and NUMA
        affinity are not weighed yet."""
        if size < len(required):
            raise DeviceError("allocation_size smaller than must-include set")
        if size > len(available):
            raise DeviceError("allocation_size larger than available set")
        avail = list(dict.fromkeys(available))
        for r in required:
            if r not in avail:
                raise DeviceError(f"must-include id {r} not in available set")

        by_index = {c.index: c for c in self.chips()}
        coords = {}
        chip_of = {}
        for did in avail:
            try:
                index, _ = parse_device_id(did)
            except ValueError as e:
                raise DeviceError(str(e)) from e
            if index not in by_index:
                raise DeviceError(f"unknown chip index {index} on {self._host}")
            chip = by_index[index]
            if chip.health is not Health.HEALTHY:
                if did in required:
                    raise DeviceError(f"must-include id {did} is unhealthy")
                continue  # never recommend a GPU Allocate would reject
            coords[did] = chip.coord
            chip_of[did] = index
        healthy_avail = [d for d in avail if d in coords]
        if size > len(healthy_avail):
            raise DeviceError(
                f"only {len(healthy_avail)} healthy devices for size {size}"
            )

        sim = self._config.backend == "sim"
        broken = set(self._gi.link_faults())

        def affinity(a: str, b: str) -> int:
            if chip_of[a] == chip_of[b]:
                return 2
            if not sim:
                return 1
            if coords[a] not in self._mesh.neighbors(coords[b]):
                return 0
            if canonical_link(coords[a], coords[b]) in broken:
                return 0
            return 1

        chosen: list[str] = list(required)
        while len(chosen) < size:
            best, best_score = None, (-1, 0)
            for cand in healthy_avail:
                if cand in chosen:
                    continue
                adj = sum(affinity(cand, other) for other in chosen)
                # tie-break deterministically by available-list position
                score = (adj, -healthy_avail.index(cand))
                if best is None or score > best_score:
                    best, best_score = cand, score
            chosen.append(best)
        return chosen

    # -- telemetry ---------------------------------------------------------
    def telemetry_snapshot(self) -> list[ChipTelemetry]:
        """One sample per GPU: health, memory in use, duty cycle, and a
        cumulative link-error counter (one count per poll per downed link
        endpoint on the GPU, as in the reference). The sim backend
        synthesizes memory and duty cycle from (tick, GPU index) exactly as
        the reference does; the real backend reads them from NVML (memory
        in use, GPU utilization), which has what libtpu lacks."""
        chips = self.chips()
        bad_ends: dict[TopologyCoord, int] = {}
        for a, b in self._gi.link_faults():
            for end in (TopologyCoord.of(a), TopologyCoord.of(b)):
                bad_ends[end] = bad_ends.get(end, 0) + 1
        sim = self._config.backend == "sim"
        out: list[ChipTelemetry] = []
        with self._lock:
            self._telemetry_ticks += 1
            tick = self._telemetry_ticks
            for c in chips:
                down = bad_ends.get(c.coord, 0)
                if down:
                    self._link_error_counts[c.index] = (
                        self._link_error_counts.get(c.index, 0) + down
                    )
                if c.health is not Health.HEALTHY:
                    duty, hbm_used = 0.0, 0
                elif sim:
                    duty = 55.0 + (tick * 7 + c.index * 13) % 40
                    hbm_used = c.hbm_bytes * (
                        35 + (tick * 3 + c.index * 5) % 50
                    ) // 100
                else:
                    util, hbm_used = self._gi.telemetry(c.index)
                    duty = float(util)
                out.append(ChipTelemetry(
                    device_id=c.device_id(),
                    index=c.index,
                    coord=c.coord,
                    health=c.health,
                    hbm_total_bytes=c.hbm_bytes,
                    hbm_used_bytes=hbm_used,
                    duty_cycle_percent=duty,
                    ici_link_errors=self._link_error_counts.get(c.index, 0),
                    links_down=down,
                ))
        return out

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
