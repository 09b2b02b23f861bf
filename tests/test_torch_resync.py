"""The port's incremental resync log (``ClusterState.allocs_since``, the
lifecycle loop's mirror in ``tpukube_torch/apiserver.py``, the
``tpukube_resync_*`` series and the ``/statusz`` ``resync`` section)
held against the reference's.

Twins (``run_twin``, both packages, decision by decision): test_ingest.py's
resync tests (the change log's property, gap, restart and disabled
answers; the lifecycle loop riding it; the router's federated
``allocs_since``; a killed replica's warm restart from its journal
segment). ``test_generation_rides_checkpoint`` is twinned with the other
checkpoint tests in tests/test_torch_journal.py.

The port's own: the resync halves of test_ingest.py's statusz and series
tests on both packages, and ``allocs_since`` answering as the reference's
cursor for cursor over a seeded commit/release trace, log overflows
included."""

import random

import pytest

import test_ingest
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import AllocResult as RefAllocResult
from tpukube.metrics import render_extender_metrics as ref_render
from tpukube.obs.statusz import extender_statusz as ref_statusz
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSim
from tpukube_torch.core import codec
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import AllocResult, make_device_id
from tpukube_torch.metrics import render_extender_metrics
from tpukube_torch.obs.statusz import extender_statusz
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sim import SimCluster
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, run_twin

use_private_tpuinfo()

RESYNC_TESTS = (
    "test_allocs_since_equals_full_read_property",
    "test_allocs_since_gap_and_restart_degrade_to_full",
    "test_allocs_since_disabled_returns_none",
    "test_lifecycle_resync_rides_the_generation_log",
    "test_lifecycle_resync_gap_falls_back_full_never_stale",
    "test_lifecycle_resync_disabled_keeps_legacy_reads",
    "test_federated_allocs_since_incremental_and_kill_fallback",
    "test_restart_replica_replays_journal_segment_warm",
)


@pytest.mark.parametrize("name", RESYNC_TESTS)
def test_reference_resync_tests_hold_on_the_port(name):
    run_twin(vars(test_ingest)[name], TMP_PATH)


# -- the resync halves of the statusz and series tests ------------------------

PACKAGES = (
    (SimCluster, load_config, extender_statusz, render_extender_metrics),
    (RefSim, ref_load_config, ref_statusz, ref_render),
)


@pytest.mark.parametrize("capacity", ["65536", "0"])
def test_resync_statusz_and_series_as_the_reference(capacity):
    # test_ingest's test_ingest_and_resync_statusz_sections and
    # test_ingest_resync_series_render_only_when_on, resync halves: two
    # churned pods, the bootstrap full read then one incremental
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_GENERATION_LOG_CAPACITY": capacity}
    docs, series = [], []
    for sim, load, statusz, render in PACKAGES:
        with sim(load(env=env)) as c:
            for name in ("p", "q"):
                c.schedule(c.make_pod(name, tpu=1))
                c.complete_pod(name)
            docs.append(statusz(c.extender, lifecycle=c._lifecycle)["resync"])
            page = render(c.extender, lifecycle=c._lifecycle)
            series.append([line for line in page.splitlines()
                           if "tpukube_resync_" in line])
    assert docs[0] == docs[1]
    assert series[0] == series[1]
    if capacity == "0":
        assert docs[0] == {"enabled": False} and series[0] == []
    else:
        assert docs[0]["enabled"] is True
        assert (docs[0]["full"], docs[0]["incremental"]) == (1, 1)
        assert docs[0]["bytes"] > 0
        assert "tpukube_resync_incremental_total 1" in series[0]


# -- allocs_since, cursor for cursor -------------------------------------------

def _answer(delta):
    """An allocs_since answer less its cursor's incarnation token (a pid
    and a per-process count, which differ by process, not by code)."""
    if delta is None:
        return None
    out = {"gen": delta["cursor"][1], "bytes": delta["bytes"]}
    for key in ("full", "adds"):
        if key in delta:
            out[key] = sorted(codec.encode_alloc(a) for a in delta[key])
    if "removes" in delta:
        out["removes"] = sorted(delta["removes"])
    return out


@pytest.mark.parametrize("seed,capacity", [(1, 65536), (2, 6), (3, 2)])
def test_allocs_since_answers_as_the_reference_cursor_for_cursor(seed,
                                                                 capacity):
    # one seeded trace of commits and releases on both packages' ledgers
    # (capacities 6 and 2 overflow the log between reads, forcing full
    # answers); each package reads with its own cursor, and every answer
    # must carry the same generation, allocations, removals and bytes
    items = test_ingest._mixed_items()
    hosts = test_ingest.MESH.all_hosts()[4:]
    exts = []
    for ext_cls, load in ((Extender, load_config), (RefExtender, ref_load_config)):
        ext = ext_cls(load(env=REF_SIM_DEFAULTS))
        assert all(r == {"ours": True} for r in ext.upsert_nodes_many(items))
        ext.state.set_generation_log(capacity)
        exts.append(ext)
    rng = random.Random(seed)
    free = [(h, i, c) for h in hosts
            for i, c in enumerate(test_ingest.MESH.coords_of_host(h))]
    live: dict[str, tuple] = {}
    cursors = [None, None]
    seq = fulls = 0
    for step in range(150):
        if free and (not live or rng.random() < 0.55):
            node, idx, coord = free.pop(rng.randrange(len(free)))
            key = f"default/p{seq}"
            seq += 1
            for ext, cls in zip(exts, (AllocResult, RefAllocResult)):
                ext.state.commit(cls(pod_key=key, node_name=node,
                                     device_ids=[make_device_id(idx)],
                                     coords=[coord]))
            live[key] = (node, idx, coord)
        else:
            key = rng.choice(sorted(live))
            free.append(live.pop(key))
            for ext in exts:
                ext.state.release(key)
        if rng.random() < 0.3:
            got, want = (ext.state.allocs_since(cur)
                         for ext, cur in zip(exts, cursors))
            assert _answer(got) == _answer(want), (seed, step)
            cursors = [got["cursor"], want["cursor"]]
            fulls += "full" in got
    assert fulls >= 1
    if capacity < 150:
        assert fulls > 1  # the log overflowed between reads
