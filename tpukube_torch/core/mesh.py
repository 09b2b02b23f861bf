"""Mesh geometry (L0) of the port — its own copy of ``MeshSpec``, ``Box``,
``surface`` and ``factor_shapes`` from ``tpukube/core/mesh.py``.

A node's GPUs are a line (dims = host_block = (n, 1, 1), no torus) on the
real backend; the sim backend and the scheduler keep the reference's full
3D mesh, so the two packages can be held against each other and an HGX
fleet is one more mesh (see :class:`MeshSpec`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from tpukube_torch.core.types import TopologyCoord


@dataclass(frozen=True)
class MeshSpec:
    """Shape of the chip mesh and its partition into hosts.

    dims:       chips along (x, y, z). 2D topologies use z=1.
    host_block: chips per host along each axis; must divide dims elementwise.
    torus:      per-axis wraparound (neighbour enumeration).

    An HGX H100 fleet is ``MeshSpec(dims=(8, H, 1), host_block=(8, 1, 1))``
    with no torus: the 8 GPUs of a host share one NVSwitch, so a host is
    one x-row of 8; the H hosts lie along y (one IB leaf), leaves along z.
    A box of (8, k, 1) is k whole hosts; a contiguous box along y keeps a
    gang's hosts adjacent.
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

    # -- basic counts ------------------------------------------------------
    @property
    def num_chips(self) -> int:
        x, y, z = self.dims
        return x * y * z

    @property
    def chips_per_host(self) -> int:
        a, b, c = self.host_block
        return a * b * c

    @property
    def host_grid(self) -> tuple[int, int, int]:
        return tuple(d // h for d, h in zip(self.dims, self.host_block))  # type: ignore[return-value]

    @property
    def num_hosts(self) -> int:
        a, b, c = self.host_grid
        return a * b * c

    # -- coordinate enumeration -------------------------------------------
    def contains(self, c: TopologyCoord) -> bool:
        return all(0 <= v < d for v, d in zip(c, self.dims))

    def all_coords(self) -> Iterator[TopologyCoord]:
        X, Y, Z = self.dims
        for z in range(Z):
            for y in range(Y):
                for x in range(X):
                    yield TopologyCoord(x, y, z)

    def linearize(self, c: TopologyCoord) -> int:
        """Row-major (x fastest) chip index within the global mesh."""
        X, Y, _ = self.dims
        return c.x + X * (c.y + Y * c.z)

    def delinearize(self, i: int) -> TopologyCoord:
        X, Y, Z = self.dims
        if not 0 <= i < self.num_chips:
            raise ValueError(f"chip index {i} out of range for {self.dims}")
        return TopologyCoord(i % X, (i // X) % Y, i // (X * Y))

    # -- host partition ----------------------------------------------------
    def host_of(self, c: TopologyCoord) -> str:
        """Stable host name owning coordinate ``c`` ("host-i-j-k")."""
        # memoized: the scheduler asks this for every reservation coord on
        # every node of every webhook (hot; the cache lives in __dict__ and
        # is invisible to the frozen dataclass' eq/hash)
        cache = self.__dict__.get("_host_of_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_host_of_cache", cache)
        h = cache.get(c)
        if h is None:
            if not self.contains(c):
                raise ValueError(f"coord {c} outside mesh {self.dims}")
            i, j, k = (v // b for v, b in zip(c, self.host_block))
            h = cache[c] = f"host-{i}-{j}-{k}"
        return h

    def host_origin(self, host: str) -> TopologyCoord:
        try:
            prefix, i, j, k = host.split("-")
            if prefix != "host":
                raise ValueError(host)
            grid = (int(i), int(j), int(k))
        except ValueError as e:
            raise ValueError(f"malformed host name {host!r}") from e
        ga, gb, gc = self.host_grid
        if not (0 <= grid[0] < ga and 0 <= grid[1] < gb and 0 <= grid[2] < gc):
            raise ValueError(f"host {host!r} outside host grid {self.host_grid}")
        return TopologyCoord(*(g * h for g, h in zip(grid, self.host_block)))

    def coords_of_host(self, host: str) -> list[TopologyCoord]:
        ox, oy, oz = self.host_origin(host)
        hx, hy, hz = self.host_block
        return [
            TopologyCoord(ox + dx, oy + dy, oz + dz)
            for dz in range(hz)
            for dy in range(hy)
            for dx in range(hx)
        ]

    def all_hosts(self) -> list[str]:
        ga, gb, gc = self.host_grid
        return [
            f"host-{i}-{j}-{k}"
            for k in range(gc)
            for j in range(gb)
            for i in range(ga)
        ]

    # -- adjacency ---------------------------------------------------------
    def neighbors(self, c: TopologyCoord) -> list[TopologyCoord]:
        """Mesh neighbours of a chip (±1 per axis, honouring per-axis
        torus), in the reference's order."""
        out: list[TopologyCoord] = []
        for axis in range(3):
            d = self.dims[axis]
            if d == 1:
                continue
            for step in (-1, 1):
                v = list(c)
                v[axis] += step
                if not 0 <= v[axis] < d:
                    if not self.torus[axis]:
                        continue
                    v[axis] %= d
                nb = TopologyCoord(*v)
                if nb != c and nb not in out:
                    out.append(nb)
        return out

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> dict:
        return {
            "dims": list(self.dims),
            "host_block": list(self.host_block),
            "torus": list(self.torus),
        }

    @staticmethod
    def from_json(obj: dict) -> "MeshSpec":
        return MeshSpec(
            dims=tuple(obj["dims"]),
            host_block=tuple(obj.get("host_block", (2, 2, 1))),
            torus=tuple(obj.get("torus", (False, False, False))),
        )


@dataclass(frozen=True)
class Box:
    """Axis-aligned sub-box [origin, origin+shape) of a mesh — the unit of
    gang placement (a contiguous sub-slice)."""

    origin: TopologyCoord
    shape: tuple[int, int, int]

    def __post_init__(self) -> None:
        if any(s <= 0 for s in self.shape):
            raise ValueError(f"non-positive box shape {self.shape}")

    @property
    def size(self) -> int:
        a, b, c = self.shape
        return a * b * c

    def coords(self) -> Iterator[TopologyCoord]:
        ox, oy, oz = self.origin
        sx, sy, sz = self.shape
        for z in range(sz):
            for y in range(sy):
                for x in range(sx):
                    yield TopologyCoord(ox + x, oy + y, oz + z)

    def contains(self, c: TopologyCoord) -> bool:
        return all(o <= v < o + s for v, o, s in zip(c, self.origin, self.shape))

    def fits_in(self, mesh: MeshSpec) -> bool:
        return all(
            0 <= o and o + s <= d
            for o, s, d in zip(self.origin, self.shape, mesh.dims)
        )

    def to_json(self) -> dict:
        return {"origin": list(self.origin), "shape": list(self.shape)}

    @staticmethod
    def from_json(obj: dict) -> "Box":
        return Box(TopologyCoord.of(obj["origin"]), tuple(obj["shape"]))


def surface(shape: tuple[int, int, int]) -> int:
    """Surface area of a box shape — the compactness measure used both for
    shape ranking here and box scoring in slicefit (lower = more compact)."""
    a, b, c = shape
    return 2 * (a * b + b * c + a * c)


def factor_shapes(n: int, mesh_dims: tuple[int, int, int]) -> list[tuple[int, int, int]]:
    """All 3D box shapes of volume n that could fit in ``mesh_dims``.

    Used by slicefit when a gang requests a count without pinning a shape.
    Deterministic order: sorted by descending "compactness" (minimize
    surface area), then lexicographically.
    """
    shapes: set[tuple[int, int, int]] = set()
    X, Y, Z = mesh_dims
    for a in range(1, min(n, X) + 1):
        if n % a:
            continue
        rem = n // a
        for b in range(1, min(rem, Y) + 1):
            if rem % b:
                continue
            c = rem // b
            if c <= Z:
                shapes.add((a, b, c))

    return sorted(shapes, key=lambda s: (surface(s), s))
