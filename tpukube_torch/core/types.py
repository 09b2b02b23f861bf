"""Shared core types (L0) of the port — its own copy of the part of
``tpukube/core/types.py`` the node agent needs.

The wire names are unchanged: device ids are ``tpu-<i>`` for a whole GPU
and ``tpu-<i>-frac<k>of<n>`` for a share, because the scheduler extender
parses them (and the port's extender must parse the same ids). A chip here
is one GPU: ``chip_id`` is its NVML UUID, ``num_cores`` its SM count.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum
from typing import NamedTuple, Optional

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
    capacity: dict[str, int] = field(default_factory=dict)
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
