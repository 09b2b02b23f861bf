"""Shared core types (L0) of the port — its own copy of
``tpukube/core/types.py``: the node agent's chip inventory and the
scheduler's pods, gangs and allocations, field for field.

The wire names are unchanged: device ids are ``tpu-<i>`` for a whole GPU
and ``tpu-<i>-frac<k>of<n>`` for a share, because the scheduler extender
parses them (and the port's extender must parse the same ids). A chip here
is one GPU: ``chip_id`` is its NVML UUID, ``num_cores`` its SM count.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Iterator, Mapping, NamedTuple, Optional

# Resources advertised to the cluster (wire names kept): whole GPUs, and
# fractional shares as a distinct extended resource.
RESOURCE_TPU = "qiniu.com/tpu"
RESOURCE_VTPU = "qiniu.com/vtpu"

DEFAULT_SLICE = "slice-0"

# Device-id scheme minted by the node agent:
#   whole GPU:        tpu-<index>
#   fractional share: tpu-<index>-frac<k>of<n>
_DEVICE_ID_RE = re.compile(r"^tpu-(\d+)(?:-frac(\d+)of(\d+))?$")


def make_device_id(chip_index: int, frac: Optional[tuple[int, int]] = None) -> str:
    if frac is None:
        return f"tpu-{chip_index}"
    k, n = frac
    return f"tpu-{chip_index}-frac{k}of{n}"


def parse_device_id(device_id: str) -> tuple[int, Optional[tuple[int, int]]]:
    """Return (chip_index, (k, n) | None). Raises ValueError on junk."""
    m = _DEVICE_ID_RE.match(device_id)
    if not m:
        raise ValueError(f"malformed tpu device id: {device_id!r}")
    chip = int(m.group(1))
    if m.group(2) is None:
        return chip, None
    return chip, (int(m.group(2)), int(m.group(3)))


class Health(str, Enum):
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"


class TopologyCoord(NamedTuple):
    """Position of a chip in the mesh (x fastest-varying)."""

    x: int
    y: int
    z: int

    def as_list(self) -> list[int]:
        return [self.x, self.y, self.z]

    @staticmethod
    def of(seq) -> "TopologyCoord":
        x, y, z = seq
        return TopologyCoord(int(x), int(y), int(z))


# A link is an unordered pair of adjacent chip coords; the canonical form
# (lexicographically smaller endpoint first) makes pairs reported by either
# endpoint compare equal.
Link = tuple[TopologyCoord, TopologyCoord]


def canonical_link(a, b) -> Link:
    a, b = TopologyCoord.of(a), TopologyCoord.of(b)
    return (a, b) if a <= b else (b, a)


class ResourceList(dict):
    """name -> integer quantity, with the arithmetic schedulers need.

    Flat extended-resource names; topology travels in the
    :mod:`tpukube_torch.core.codec` annotations, not in the name.
    """

    def __init__(self, items: Optional[Mapping[str, int]] = None, **kw: int):
        super().__init__()
        for src in (items or {}), kw:
            for k, v in src.items():
                self[k] = int(v)

    def fits(self, capacity: "ResourceList") -> bool:
        """True if every requested quantity is available in ``capacity``."""
        return all(capacity.get(k, 0) >= v for k, v in self.items())

    def plus(self, other: Mapping[str, int]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) + int(v)
        return out

    def minus(self, other: Mapping[str, int]) -> "ResourceList":
        out = ResourceList(self)
        for k, v in other.items():
            out[k] = out.get(k, 0) - int(v)
        return out

    def nonneg(self) -> bool:
        return all(v >= 0 for v in self.values())


@dataclass
class ChipInfo:
    """One GPU as seen by the node agent."""

    chip_id: str  # NVML UUID on the real backend
    index: int  # node-local index (== NVML index; device-id minting)
    coord: TopologyCoord
    hbm_bytes: int
    num_cores: int = 2  # SMs on the real backend
    health: Health = Health.HEALTHY

    def device_id(self) -> str:
        return make_device_id(self.index)


@dataclass
class VtpuShare:
    """A minted fractional share of a chip (wire name kept)."""

    chip_index: int
    k: int  # share index, 0-based
    n: int  # shares per chip
    hbm_quota_bytes: int

    def device_id(self) -> str:
        return make_device_id(self.chip_index, (self.k, self.n))


@dataclass
class NodeInfo:
    """Everything the scheduler needs to know about one node's chips
    (travels as the ``tpu.qiniu.com/node-topology`` annotation)."""

    name: str
    chips: list[ChipInfo] = field(default_factory=list)
    shares_per_chip: int = 1
    capacity: ResourceList = field(default_factory=ResourceList)
    annotations: dict[str, str] = field(default_factory=dict)
    # downed links with at least one endpoint on this node (canonical pairs)
    bad_links: list[Link] = field(default_factory=list)
    slice_id: str = DEFAULT_SLICE
    # where the chip inventory came from ("sim", "nvml")
    source: str = ""

    def healthy_chips(self) -> list[ChipInfo]:
        return [c for c in self.chips if c.health is Health.HEALTHY]

    def chip_by_index(self, index: int) -> ChipInfo:
        for c in self.chips:
            if c.index == index:
                return c
        raise KeyError(f"{self.name}: no chip with index {index}")


@dataclass
class PodGroup:
    """Gang-scheduling group identity.

    ``shape`` optionally pins the requested box geometry (e.g. (8,2,1) for
    16 GPUs on two HGX hosts); None means "any contiguous box of the right
    size".
    """

    name: str
    min_member: int
    shape: Optional[tuple[int, int, int]] = None
    # Opt-in for data-parallel jobs whose gradient reduction tolerates
    # crossing slices (the data-centre network): when no single slice
    # fits, the gang may split into contiguous per-slice sub-boxes.
    # Incompatible with a shape hint (a shape names one box).
    allow_dcn: bool = False

    def __post_init__(self) -> None:
        if self.allow_dcn and self.shape is not None:
            raise ValueError(
                f"pod group {self.name!r}: allow_dcn is incompatible with a "
                f"shape hint (a shape names one contiguous box)"
            )


@dataclass
class ContainerInfo:
    name: str
    requests: ResourceList = field(default_factory=ResourceList)


@dataclass
class PodInfo:
    """The slice of a k8s Pod this framework reasons about."""

    name: str
    namespace: str = "default"
    uid: str = ""
    containers: list[ContainerInfo] = field(default_factory=list)
    priority: int = 0
    group: Optional[PodGroup] = None
    node_name: str = ""
    annotations: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"

    def requests(self) -> ResourceList:
        total = ResourceList()
        for c in self.containers:
            total = total.plus(c.requests)
        return total

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class AllocResult:
    """Outcome of placing one pod: which devices on which node, plus the
    gang env the container must receive so the in-pod runtime forms the
    intended mesh (the node agent's Allocate adds the device env)."""

    pod_key: str
    node_name: str
    device_ids: list[str] = field(default_factory=list)
    coords: list[TopologyCoord] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    # pod priority, persisted in the annotation so a restarted extender
    # rebuilds preemption protection (not just occupancy)
    priority: int = 0
    # pod UID at bind time ("" for pre-UID annotations). Pod names recur
    # — controllers recreate StatefulSet members under the same name — so
    # the UID is what lets the lifecycle release loop and the restart
    # rebuild tell THIS incarnation's allocation from a stale one
    uid: str = ""

    def chip_indices(self) -> list[int]:
        return [parse_device_id(d)[0] for d in self.device_ids]


def iter_pod_device_requests(pod: PodInfo) -> Iterator[tuple[str, int]]:
    """Yield (resource_name, count) for the TPU-flavored requests of a pod."""
    req = pod.requests()
    for name in (RESOURCE_TPU, RESOURCE_VTPU):
        n = req.get(name, 0)
        if n:
            yield name, n
