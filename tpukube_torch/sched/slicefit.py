"""slicefit — contiguous box search in a partially occupied chip mesh; the
port's own copy of ``tpukube/sched/slicefit.py``, line for line, so the
port places exactly where the reference does.

The algorithmic core of the scheduler: find an axis-aligned sub-box of the
mesh whose chips are all free, sized (or shaped) for the gang, and score
candidates so that

  * the gang gets a compact box (low surface area => short paths between
    its members: on an HGX fleet, whole hosts adjacent along y), and
  * the cluster keeps its free space defensible (corner/wall packing =>
    low fragmentation for future gangs).

Implementation: numpy occupancy voxel grid + a 3D summed-area table, so
testing "is this box fully free" is O(1) per origin and a full shape sweep
is O(X*Y*Z). Exact search with deterministic tie-breaking — mesh sizes in
scope (<= a few thousand chips) make exact affordable.

Torus axes are honored: on a wraparound axis the free grid is tiled so box
origins may wrap (a (3,1,1) slice at x in {3,0,1} of a 4-torus is
contiguous over ICI), and boundary "wall contact" is only credited on
non-torus axes (a torus has no walls).

Irregular fallback: when no box of the requested volume exists (e.g. a
5-pod gang on a 4x4 mesh), ``find_slice(..., allow_irregular=True)`` grows
a connected free region instead — gangs still land ICI-connected, just not
box-shaped. Disabled by default; the extender decides policy.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Optional

import numpy as np

from tpukube_torch.core.mesh import Box, MeshSpec, factor_shapes, surface
from tpukube_torch.core.types import Link, TopologyCoord, canonical_link

Shape = tuple[int, int, int]


def point_contact(mesh: MeshSpec, c: TopologyCoord, blocked) -> int:
    """Contact of one chip against blocked neighbors and mesh walls — the
    single definition of single-chip snugness. ``blocked(coord) -> bool``
    says whether a neighbor counts as contact; true mesh walls always do
    (axes of extent 1 contribute both walls; a length-2 torus axis reaches
    the same chip in both directions and both count, matching the box
    sweep's per-face slab sampling). Shared by _Sweep.contact_point
    (occupancy-grid form) and the extender's single-chip placement fast
    path (free-set form)."""
    total = 0
    for axis in range(3):
        d = mesh.dims[axis]
        wrap = mesh.torus[axis] and d > 1
        for step in (-1, 1):
            idx = c[axis] + step
            if wrap:
                v = list(c)
                v[axis] = idx % d
                if blocked(TopologyCoord(*v)):
                    total += 1
            elif idx < 0 or idx >= d:
                total += 1  # true mesh wall
            else:
                v = list(c)
                v[axis] = idx
                if blocked(TopologyCoord(*v)):
                    total += 1
    return total


def coords_break_link(chips: set[TopologyCoord], broken: set[Link]) -> bool:
    """True if both endpoints of any downed ICI link are in ``chips``.

    A slice containing both ends of a dead link is degraded no matter its
    geometry — XLA collectives route over mesh adjacency, so the link WILL
    carry traffic. Containment (not just internal adjacency) is the test.
    The single source of this predicate; gang sweep and placement share it.
    """
    return any(a in chips and b in chips for a, b in broken)


def box_breaks_link(
    mesh: MeshSpec, box: Box, broken: set[Link]
) -> bool:
    """``coords_break_link`` specialized to an (optionally torus-wrapped)
    box, O(|broken|) interval checks — this runs per candidate origin in the
    sweep hot loop, so no coord-set materialization."""
    if not broken:
        return False
    o, s, dims = box.origin, box.shape, mesh.dims

    def inside(p: TopologyCoord) -> bool:
        # (p - origin) mod dim < extent is exact for wrapped boxes on torus
        # axes and, because in-mesh non-torus boxes never wrap, for plain
        # axes too (the mod only bites when the box wraps).
        return all((p[i] - o[i]) % dims[i] < s[i] for i in range(3))

    return any(inside(a) and inside(b) for a, b in broken)


def occupancy_grid(mesh: MeshSpec, occupied: Iterable[TopologyCoord]) -> np.ndarray:
    """Boolean [X, Y, Z] grid, True = occupied/unavailable.

    A prebuilt boolean ndarray passes through unchanged (hot path: callers
    that already hold a grid skip the per-coord rebuild)."""
    if isinstance(occupied, np.ndarray):
        if occupied.shape != mesh.dims:
            raise ValueError(
                f"occupancy grid shape {occupied.shape} != mesh {mesh.dims}"
            )
        return occupied.astype(bool, copy=False)
    grid = np.zeros(mesh.dims, dtype=bool)
    for c in occupied:
        if not mesh.contains(TopologyCoord.of(c)):
            raise ValueError(f"occupied coord {c} outside mesh {mesh.dims}")
        grid[tuple(c)] = True
    return grid


def box_coords(mesh: MeshSpec, box: Box) -> list[TopologyCoord]:
    """Chips of a box, wrapping on torus axes (origin is always in-mesh)."""
    return [
        TopologyCoord(*(v % d for v, d in zip(c, mesh.dims)))
        for c in box.coords()
    ]


class _Sweep:
    """One occupancy snapshot prepared for repeated box queries: the free
    grid tiled along torus axes (so wrapped origins become plain origins)
    plus its zero-padded summed-area table.

    Also the FREE-BOX INDEX of the epoch-cached scheduling snapshot
    (sched/snapshot.py): ``origins``/``contacts`` results are memoized
    per shape, so a sweep reused across webhook cycles answers repeat
    shape queries from the index instead of re-scanning."""

    def __init__(self, mesh: MeshSpec, grid: np.ndarray):
        if grid.shape != mesh.dims:
            raise ValueError(f"grid shape {grid.shape} != mesh dims {mesh.dims}")
        self.mesh = mesh
        self.grid = grid
        free = ~grid
        ext = free
        for axis in range(3):
            d = mesh.dims[axis]
            if mesh.torus[axis] and d > 1:
                # tile by d-1 so any box of extent <= d can start anywhere
                wrap = ext.take(range(0, d - 1), axis=axis)
                ext = np.concatenate([ext, wrap], axis=axis)
        self.ext_free = ext
        sat = np.zeros(tuple(s + 1 for s in ext.shape), dtype=np.int64)
        sat[1:, 1:, 1:] = ext.astype(np.int64).cumsum(0).cumsum(1).cumsum(2)
        self.sat = sat
        # free-box index: shape -> origins / per-origin contact arrays
        self._origins_cache: dict[Shape, np.ndarray] = {}
        self._contacts_cache: dict[Shape, np.ndarray] = {}

    def origins(self, shape: Shape) -> np.ndarray:
        """[N, 3] origins (in-mesh) where a `shape` box is entirely free,
        wrapping over torus axes. Lexicographic order; full-extent boxes on
        a torus axis are canonicalized to origin 0 (all origins would name
        the same chip set). Memoized per shape — callers must not mutate
        the returned array."""
        cached = self._origins_cache.get(shape)
        if cached is not None:
            return cached
        out = self._compute_origins(shape)
        self._origins_cache[shape] = out
        return out

    def _compute_origins(self, shape: Shape) -> np.ndarray:
        s = self.sat
        a, b, c = shape
        dims = self.mesh.dims
        for extent, d in zip(shape, dims):
            if extent > d:
                return np.empty((0, 3), dtype=int)
        eX, eY, eZ = self.ext_free.shape
        if a > eX or b > eY or c > eZ:
            return np.empty((0, 3), dtype=int)
        vol = (
            s[a:, b:, c:]
            - s[:-a, b:, c:]
            - s[a:, :-b, c:]
            - s[a:, b:, :-c]
            + s[:-a, :-b, c:]
            + s[:-a, b:, :-c]
            + s[a:, :-b, :-c]
            - s[:-a, :-b, :-c]
        )
        origins = np.argwhere(vol == a * b * c)
        if origins.size == 0:
            return origins
        # keep origins that are in-mesh and legal for each axis
        keep = np.ones(len(origins), dtype=bool)
        for axis, extent in enumerate(shape):
            d = dims[axis]
            if self.mesh.torus[axis] and d > 1:
                if extent == d:
                    keep &= origins[:, axis] == 0
                else:
                    keep &= origins[:, axis] < d
            else:
                keep &= origins[:, axis] <= d - extent
        return origins[keep]

    def contact_point(self, c: TopologyCoord) -> int:
        """``contact`` specialized to a single chip (1x1x1 box) — the
        per-chip snugness loop of /prioritize calls this per node per pod,
        where the general slab machinery below is ~10x the cost."""
        g = self.grid
        return point_contact(self.mesh, c, lambda nb: bool(g[nb]))

    def contact_grid(self) -> np.ndarray:
        """Per-chip contact against this grid for EVERY mesh cell at once —
        one vectorized stencil replaces a Python point_contact per chip
        when a webhook scores hundreds of nodes. Cached per sweep; must
        agree cell-for-cell with contact_point (tested)."""
        cached = getattr(self, "_contact_grid", None)
        if cached is not None:
            return cached
        g = self.grid.astype(np.int16)
        out = np.zeros(g.shape, np.int16)
        for axis in range(3):
            d = g.shape[axis]
            if self.mesh.torus[axis] and d > 1:
                out += np.roll(g, 1, axis=axis) + np.roll(g, -1, axis=axis)
                continue
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            # -1 neighbor: wall on plane 0, shifted occupancy elsewhere
            lo[axis] = 0
            out[tuple(lo)] += 1
            if d > 1:
                dst, src = [slice(None)] * 3, [slice(None)] * 3
                dst[axis], src[axis] = slice(1, None), slice(0, -1)
                out[tuple(dst)] += g[tuple(src)]
            # +1 neighbor: wall on plane d-1, shifted occupancy elsewhere
            hi[axis] = d - 1
            out[tuple(hi)] += 1
            if d > 1:
                dst, src = [slice(None)] * 3, [slice(None)] * 3
                dst[axis], src[axis] = slice(0, -1), slice(1, None)
                out[tuple(dst)] += g[tuple(src)]
        self._contact_grid = out
        return out

    def _box_free(self, starts: np.ndarray, shape: Shape) -> np.ndarray:
        """Free-chip count of a ``shape`` box at every start in
        ``starts`` ([N, 3], ext-grid coordinates) — one vectorized
        8-corner gather over the summed-area table, no per-origin loop."""
        s = self.sat
        x0, y0, z0 = starts[:, 0], starts[:, 1], starts[:, 2]
        x1, y1, z1 = x0 + shape[0], y0 + shape[1], z0 + shape[2]
        return (
            s[x1, y1, z1] - s[x0, y1, z1] - s[x1, y0, z1] - s[x1, y1, z0]
            + s[x0, y0, z1] + s[x0, y1, z0] + s[x1, y0, z0] - s[x0, y0, z0]
        )

    def contacts(self, shape: Shape) -> np.ndarray:
        """``contact`` for EVERY free origin of ``shape`` at once (aligned
        with ``origins(shape)``): each face's adjacent slab is itself a
        box, so its occupied count is (slab area - free count) read off
        the same integral image — the whole shape tier scores in a
        handful of numpy gathers instead of a per-origin Python loop.
        Must agree entry-for-entry with ``contact`` (property-tested)."""
        cached = self._contacts_cache.get(shape)
        if cached is not None:
            return cached
        origins = self.origins(shape)
        total = np.zeros(len(origins), dtype=np.int64)
        dims = self.mesh.dims
        for axis in range(3):
            if len(origins) == 0:
                break
            d = dims[axis]
            extent = shape[axis]
            slab = list(shape)
            slab[axis] = 1
            slab_shape = (slab[0], slab[1], slab[2])
            area = slab[0] * slab[1] * slab[2]  # face area
            axv = origins[:, axis]
            if self.mesh.torus[axis] and d > 1:
                if extent == d:
                    continue  # box spans the whole ring: no face
                lo = origins.copy()
                lo[:, axis] = (axv - 1) % d
                hi = origins.copy()
                hi[:, axis] = axv + extent  # <= 2d-2, inside the tiling
                total += area - self._box_free(lo, slab_shape)
                total += area - self._box_free(hi, slab_shape)
            else:
                wall_lo = axv == 0
                lo = origins.copy()
                lo[:, axis] = np.maximum(axv - 1, 0)  # clamp; walls masked
                total += np.where(
                    wall_lo, area, area - self._box_free(lo, slab_shape)
                )
                wall_hi = axv + extent >= d
                hi = origins.copy()
                hi[:, axis] = np.minimum(axv + extent, d - 1)
                total += np.where(
                    wall_hi, area, area - self._box_free(hi, slab_shape)
                )
        self._contacts_cache[shape] = total
        return total

    def contact(self, box: Box) -> int:
        """Faces of the box touching a mesh wall or occupied chips.

        Higher contact = snugger placement = less fragmentation of the
        remaining free space (3D best-fit/corner packing). Wall credit only
        exists on non-torus axes; on torus axes the adjacent slab is taken
        modulo the dimension.
        """
        if box.shape == (1, 1, 1):
            return self.contact_point(TopologyCoord.of(box.origin))
        g = self.grid
        mesh = self.mesh
        X, Y, Z = g.shape
        (ox, oy, oz), (sx, sy, sz) = box.origin, box.shape

        def ax_idx(vals, d):
            return np.asarray(vals) % d

        xs = ax_idx(range(ox, ox + sx), X)
        ys = ax_idx(range(oy, oy + sy), Y)
        zs = ax_idx(range(oz, oz + sz), Z)
        total = 0
        # (axis, face_lo, slab_index, face_area, plane_sel)
        faces = [
            (0, ox - 1, ox + sx, sy * sz, np.ix_(ys, zs)),
            (1, oy - 1, oy + sy, sx * sz, np.ix_(xs, zs)),
            (2, oz - 1, oz + sz, sx * sy, np.ix_(xs, ys)),
        ]
        for axis, lo, hi, area, sel in faces:
            d = g.shape[axis]
            extent = box.shape[axis]
            for idx in (lo, hi):
                if mesh.torus[axis] and d > 1:
                    if extent == d:
                        continue  # box spans the whole ring: no face
                    slab = np.take(g, idx % d, axis=axis)
                    total += int(slab[sel].sum())
                else:
                    if idx < 0 or idx >= d:
                        total += area  # true mesh wall
                    else:
                        slab = np.take(g, idx, axis=axis)
                        total += int(slab[sel].sum())
        return total


@dataclass(frozen=True)
class ScoredBox:
    box: Box
    # Lower is better on each component, compared in order:
    surface: int       # box surface area — gang-internal ICI compactness
    contact: int       # NEGATED wall/occupied contact — cluster packing
    origin_key: Shape  # deterministic final tie-break

    @property
    def sort_key(self) -> tuple:
        return (self.surface, self.contact, self.origin_key)


@lru_cache(maxsize=4096)
def _candidate_shapes_for(
    dims: Shape, count: Optional[int], shape: Optional[Shape]
) -> tuple[Shape, ...]:
    """Memoized shape enumeration: the candidate list depends only on
    (mesh dims, count, shape), and the same handful of requests repeats
    on every webhook — re-factoring the volume each time was measurable
    on the filter/prioritize microbench."""
    if shape is not None:
        perms = sorted(set(itertools.permutations(shape)))
        return tuple(
            p for p in perms if all(s <= d for s, d in zip(p, dims))
        )
    assert count is not None
    return tuple(factor_shapes(count, dims))  # already compactness-sorted


def _candidate_shapes(
    mesh: MeshSpec, count: Optional[int], shape: Optional[Shape]
) -> tuple[Shape, ...]:
    """Shapes to sweep, most-preferred first.

    A pinned shape is honored up to axis permutation (a 4x4x1 request is
    geometrically the same slice as 1x4x4; jobs index their mesh axes
    logically, the physical orientation is the scheduler's choice).
    """
    return _candidate_shapes_for(
        mesh.dims, count, None if shape is None else tuple(shape)
    )


def _validate_request(count: Optional[int], shape: Optional[Shape]) -> None:
    if (count is None) == (shape is None):
        raise ValueError("exactly one of count/shape must be given")
    if count is not None and count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    if shape is not None and any(s < 1 for s in shape):
        raise ValueError(f"shape dims must be >= 1, got {shape}")


def _boxes_clear_of_links(
    dims: Shape, origins: np.ndarray, shape: Shape, broken: set[Link]
) -> np.ndarray:
    """Boolean keep-mask over ``origins``: False where a ``shape`` box at
    that origin contains BOTH endpoints of a downed link — the batched
    form of ``box_breaks_link`` (same wrapped-interval test, one numpy
    comparison per link instead of a per-origin Python call)."""
    keep = np.ones(len(origins), dtype=bool)
    dims_a = np.asarray(dims)
    shape_a = np.asarray(shape)
    for a, b in broken:
        in_a = np.all((np.asarray(a) - origins) % dims_a < shape_a, axis=1)
        in_b = np.all((np.asarray(b) - origins) % dims_a < shape_a, axis=1)
        keep &= ~(in_a & in_b)
    return keep


def iter_free_boxes_in(
    sweep: _Sweep,
    count: Optional[int] = None,
    shape: Optional[Shape] = None,
    broken: Optional[set[Link]] = None,
) -> Iterable[ScoredBox]:
    """``iter_free_boxes`` over a PREPARED sweep (the snapshot fast
    path): origins and contact scores come batched per shape tier from
    the sweep's free-box index; only the yield loop is Python."""
    _validate_request(count, shape)
    mesh = sweep.mesh
    for shp in _candidate_shapes(mesh, count, shape):
        origins = sweep.origins(shp)
        if len(origins) == 0:
            continue
        contacts = sweep.contacts(shp)
        if broken:
            keep = _boxes_clear_of_links(mesh.dims, origins, shp, broken)
            origins, contacts = origins[keep], contacts[keep]
        s = surface(shp)
        for origin, contact in zip(origins, contacts):
            ok = (int(origin[0]), int(origin[1]), int(origin[2]))
            yield ScoredBox(
                box=Box(TopologyCoord(*ok), shp),
                surface=s,
                contact=-int(contact),
                origin_key=ok,
            )


def iter_free_boxes(
    mesh: MeshSpec,
    grid: np.ndarray,
    count: Optional[int] = None,
    shape: Optional[Shape] = None,
    broken: Optional[set[Link]] = None,
) -> Iterable[ScoredBox]:
    """All fully-free boxes matching the request, scored, unsorted.
    Boxes spanning a downed ICI link (``broken``) are excluded.
    Thin wrapper: callers holding a scheduling snapshot use
    ``iter_free_boxes_in`` and skip the per-call sweep build."""
    return iter_free_boxes_in(_Sweep(mesh, grid), count=count,
                              shape=shape, broken=broken)


def find_slice_in(
    sweep: _Sweep,
    count: Optional[int] = None,
    shape: Optional[Shape] = None,
    allow_irregular: bool = False,
    broken: Optional[set[Link]] = None,
) -> Optional[list[TopologyCoord]]:
    """``find_slice`` over a PREPARED sweep — the snapshot fast path.

    The all-free test for every origin of a shape is one integral-image
    subtraction (``_Sweep.origins``), contact scoring is batched per
    shape tier (``_Sweep.contacts``), and the best candidate of a tier
    falls out of one ``lexsort`` — no per-origin Python loop anywhere.
    Selection order is bit-identical to the reference sweep: surface
    strictly dominates, then max contact, then lexicographic origin,
    first shape in candidate order winning ties.
    """
    _validate_request(count, shape)
    mesh = sweep.mesh
    best_key: Optional[tuple] = None
    best_box: Optional[Box] = None
    tier: Optional[int] = None
    for shp in _candidate_shapes(mesh, count, shape):
        s = surface(shp)
        if tier is not None and s > tier:
            break  # strictly worse tier; current best cannot be beaten
        origins = sweep.origins(shp)
        if len(origins) == 0:
            continue
        contacts = sweep.contacts(shp)
        if broken:
            keep = _boxes_clear_of_links(mesh.dims, origins, shp, broken)
            origins, contacts = origins[keep], contacts[keep]
            if len(origins) == 0:
                continue
        # best of this tier: max contact, then lexicographic origin
        # (lexsort keys are minor-to-major, so -contacts is primary)
        i = int(np.lexsort(
            (origins[:, 2], origins[:, 1], origins[:, 0], -contacts)
        )[0])
        key = (
            s,
            -int(contacts[i]),
            (int(origins[i, 0]), int(origins[i, 1]), int(origins[i, 2])),
        )
        if best_key is None or key < best_key:
            best_key = key
            best_box = Box(TopologyCoord(*key[2]), shp)
            tier = s
    if best_box is not None:
        return box_coords(mesh, best_box)
    if allow_irregular and shape is None and count is not None:
        return _find_connected(mesh, sweep.grid, count, broken)
    return None


def find_slice(
    mesh: MeshSpec,
    occupied: Iterable[TopologyCoord],
    count: Optional[int] = None,
    shape: Optional[Shape] = None,
    allow_irregular: bool = False,
    broken: Optional[set[Link]] = None,
) -> Optional[list[TopologyCoord]]:
    """Best placement for a gang: the chips of the best free box, or (with
    ``allow_irregular``) a connected free region when no box exists.

    Returns None when the request cannot be satisfied at all. Candidates
    spanning a downed ICI link (``broken``, canonical pairs) are rejected.

    Surface area strictly dominates the score, so the sweep stops after the
    first surface tier that yields any candidate — worse-surface shapes can
    never win and are not scored (the scheduler's hot path).

    Thin wrapper: builds one throwaway sweep. Callers with a scheduling
    snapshot (sched/snapshot.py) use ``find_slice_in`` on its cached
    sweep instead.
    """
    _validate_request(count, shape)
    sweep = _Sweep(mesh, occupancy_grid(mesh, occupied))
    return find_slice_in(sweep, count=count, shape=shape,
                         allow_irregular=allow_irregular, broken=broken)


def _find_connected(
    mesh: MeshSpec, grid: np.ndarray, count: int,
    broken: Optional[set[Link]] = None,
) -> Optional[list[TopologyCoord]]:
    """Greedy connected-region growth over free chips (BFS from the most
    wall-adjacent free chip, preferring frontier chips with max contact).
    Deterministic. Used only when no box of volume ``count`` exists.
    Growth never crosses a downed link, and never ADDS a chip that would
    put both endpoints of a downed link inside the region (a region
    containing both ends of a dead link is degraded even when they joined
    through live paths — same containment rule as ``box_breaks_link``)."""
    free = {TopologyCoord(*map(int, idx)) for idx in np.argwhere(~grid)}
    if len(free) < count:
        return None
    broken = broken or set()

    def live(a: TopologyCoord, b: TopologyCoord) -> bool:
        return not broken or canonical_link(a, b) not in broken

    def degrades(c: TopologyCoord, chosen: set[TopologyCoord]) -> bool:
        return any(
            (c == a and b in chosen) or (c == b and a in chosen)
            for a, b in broken
        )

    def isolation(c: TopologyCoord) -> int:
        return -sum(1 for nb in mesh.neighbors(c) if nb in free and live(c, nb))

    # try seeds in decreasing wall/occupied-contact order; first success wins
    seeds = sorted(free, key=lambda c: (isolation(c), tuple(c)))
    for seed in seeds:
        region = [seed]
        chosen = {seed}
        while len(region) < count:
            frontier = [
                nb
                for r in region
                for nb in mesh.neighbors(r)
                if nb in free and nb not in chosen and live(r, nb)
                and not degrades(nb, chosen)
            ]
            if not frontier:
                break
            # prefer the frontier chip most connected to the region
            nxt = max(
                frontier,
                key=lambda c: (
                    sum(
                        1 for nb in mesh.neighbors(c)
                        if nb in chosen and live(c, nb)
                    ),
                    tuple(-v for v in c),
                ),
            )
            region.append(nxt)
            chosen.add(nxt)
        if len(region) == count:
            return region
    return None


def largest_free_box_in(sweep: _Sweep) -> int:
    """Volume of the largest fully-free box over a prepared sweep.

    Feasibility is monotone in each extent (a free (a, b, c) box
    contains a free (a, b, c-1) box), so for each (a, b) pair the
    maximal feasible third extent is found by BINARY search —
    O(X·Y·log Z) origin queries instead of the O(X·Y·Z) descending
    scan, which at the 10k-node meshes (32×32×40) made every
    fragmentation render a multi-thousand-tier sweep. Results are
    identical to the exhaustive scan (property-tested); repeated calls
    on a cached snapshot sweep answer from memoized origins."""
    best = 0
    X, Y, Z = sweep.mesh.dims
    for a in range(1, X + 1):
        if a * Y * Z <= best:
            continue
        for b in range(1, Y + 1):
            if a * b * Z <= best:
                continue
            # smallest c that would beat the best so far; probe it
            # first — if even that fails, no c can improve on (a, b)
            lo = best // (a * b) + 1
            if lo > Z or not len(sweep.origins((a, b, lo))):
                continue
            hi = Z
            while lo < hi:  # largest feasible c, by bisection
                mid = (lo + hi + 1) // 2
                if len(sweep.origins((a, b, mid))):
                    lo = mid
                else:
                    hi = mid - 1
            best = a * b * lo
    return best


def largest_free_box(mesh: MeshSpec, grid: np.ndarray) -> int:
    """Thin wrapper (one throwaway sweep); snapshot holders use
    ``SliceSnapshot.largest_free_box`` which memoizes per epoch."""
    return largest_free_box_in(_Sweep(mesh, grid))


def fragmentation(mesh: MeshSpec, occupied: Iterable[TopologyCoord]) -> float:
    """Free-space fragmentation in [0, 1]: 1 - (largest free box)/(free chips).

    0 = all free chips form one perfect box; -> 1 as free space shatters.
    Exported to metrics and used by tests to validate packing behavior.
    Thin wrapper: the /statusz + /metrics renders read the epoch-cached
    ``SliceSnapshot.fragmentation`` instead of rebuilding a sweep per
    scrape.
    """
    grid = occupancy_grid(mesh, occupied)
    free_count = int((~grid).sum())
    if free_count == 0:
        return 0.0
    return 1.0 - largest_free_box_in(_Sweep(mesh, grid)) / free_count
