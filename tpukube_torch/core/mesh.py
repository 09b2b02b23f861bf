"""Mesh geometry (L0) of the port — its own copy of ``MeshSpec`` from
``tpukube/core/mesh.py``, as far as the node agent needs it.

A node's GPUs are a line (dims = host_block = (n, 1, 1), no torus) on the
real backend; the sim backend keeps the reference's full 3D mesh so the two
packages can be held against each other.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshSpec:
    """Shape of the chip mesh and its partition into hosts.

    dims:       chips along (x, y, z).
    host_block: chips per host along each axis; must divide dims elementwise.
    torus:      per-axis wraparound.
    """

    dims: tuple[int, int, int]
    host_block: tuple[int, int, int] = (2, 2, 1)
    torus: tuple[bool, bool, bool] = (False, False, False)

    def __post_init__(self) -> None:
        if len(self.dims) != 3 or len(self.host_block) != 3:
            raise ValueError("dims and host_block must be 3-tuples")
        for d, h in zip(self.dims, self.host_block):
            if d <= 0 or h <= 0:
                raise ValueError(f"non-positive mesh dimension: {self}")
            if d % h != 0:
                raise ValueError(
                    f"host_block {self.host_block} does not divide dims {self.dims}"
                )
