"""The port's slicefit and scheduling snapshots held against the
reference's: the reference's own tests run on both packages, and on
randomized occupancy (from a numpy seed) both packages must choose the same
boxes, coordinate for coordinate."""

import numpy as np
import pytest

import test_slicefit
import test_snapshot
import test_snapshot_delta
from tpukube.core.mesh import MeshSpec as RefMeshSpec
from tpukube.core.types import canonical_link as ref_link
from tpukube.sched import slicefit as ref_slicefit
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import TopologyCoord, canonical_link
from tpukube_torch.sched import slicefit
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_cases, run_twin, value_fixtures

use_private_tpuinfo()

SNAPSHOT_SKIPS: dict[str, str] = {}
DELTA_SKIPS: dict[str, str] = {}
FIXTURES = {"monkeypatch": lambda g: pytest.MonkeyPatch.context()}


@pytest.mark.parametrize(
    "fn,params",
    # one case per test, and per seed of the delta property
    [pytest.param(*case.values, id=f"{case.values[0].__module__}.{case.id}")
     for case in reference_cases(test_slicefit, {})
     + reference_cases(test_snapshot, SNAPSHOT_SKIPS)
     + reference_cases(test_snapshot_delta, DELTA_SKIPS)])
def test_reference_slicefit_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**FIXTURES, **value_fixtures(params)})


# (dims, host_block, torus) — the reference's v5p-style mesh, a 2D torus,
# and two HGX fleets (8 GPUs a host, hosts along y)
MESHES = [
    ((4, 4, 4), (2, 2, 1), (False, False, False)),
    ((4, 4, 1), (2, 2, 1), (True, True, False)),
    ((8, 4, 1), (8, 1, 1), (False, False, False)),
    ((8, 16, 1), (8, 1, 1), (False, False, False)),
]


def _random_state(seed, dims, torus):
    rng = np.random.default_rng(seed)
    occ = rng.random(dims) < rng.uniform(0.05, 0.5)
    coords = [tuple(int(v) for v in c) for c in np.argwhere(occ)]
    m = RefMeshSpec(dims=dims, host_block=(1, 1, 1), torus=torus)
    links = set()
    for _ in range(int(rng.integers(0, 4))):
        a = tuple(int(rng.integers(0, d)) for d in dims)
        nbs = m.neighbors(a)
        if nbs:
            links.add(tuple(nbs[int(rng.integers(0, len(nbs)))]) + a)
    return coords, [(l[:3], l[3:]) for l in links], rng


def _norm(coords):
    return None if coords is None else [tuple(c) for c in coords]


@pytest.mark.parametrize("mesh_args", MESHES, ids=lambda a: "x".join(map(str, a[0])))
@pytest.mark.parametrize("seed", range(6))
def test_same_boxes_on_random_occupancy(mesh_args, seed):
    dims, block, torus = mesh_args
    mesh, ref_mesh = MeshSpec(dims, block, torus), RefMeshSpec(dims, block, torus)
    coords, links, rng = _random_state(seed, dims, torus)
    occ = [TopologyCoord(*c) for c in coords]
    broken = {canonical_link(a, b) for a, b in links}
    ref_broken = {ref_link(a, b) for a, b in links}
    free = mesh.num_chips - len(occ)
    counts = sorted({1, 2, 8, int(rng.integers(1, max(2, free)))})
    asks = [dict(count=n) for n in counts] + [dict(count=n, allow_irregular=True)
                                              for n in counts]
    asks += [dict(shape=(min(2, dims[0]), min(2, dims[1]), 1)),
             dict(shape=(dims[0], 1, 1))]
    for ask in asks:
        for bl, rbl in ((None, None), (broken, ref_broken)):
            got = slicefit.find_slice(mesh, occ, broken=bl, **ask)
            want = ref_slicefit.find_slice(ref_mesh, coords, broken=rbl, **ask)
            assert _norm(got) == _norm(want), (ask, bl)
    assert slicefit.fragmentation(mesh, occ) == ref_slicefit.fragmentation(ref_mesh, coords)
    grid = slicefit.occupancy_grid(mesh, occ)
    ref_grid = ref_slicefit.occupancy_grid(ref_mesh, coords)
    assert np.array_equal(grid, ref_grid)
    assert slicefit.largest_free_box(mesh, grid) == ref_slicefit.largest_free_box(
        ref_mesh, ref_grid)
    got_boxes = [(b.box.origin, b.box.shape, b.sort_key) for b in
                 slicefit.iter_free_boxes(mesh, grid, count=4, broken=broken)]
    want_boxes = [(b.box.origin, b.box.shape, b.sort_key) for b in
                  ref_slicefit.iter_free_boxes(ref_mesh, ref_grid, count=4,
                                               broken=ref_broken)]
    assert got_boxes == want_boxes
