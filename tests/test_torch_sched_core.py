"""The port's scheduler data layer (``tpukube_torch.core``: types, mesh,
codec, clock, config) held against the reference's.

The reference's own tests of ``tpukube/core/mesh.py`` and ``codec.py`` run
twice, once per package (``torch_twin``, whose port run is held to reach
only the port); the two node agents must annotate
the same sim host with the same ``node-topology`` payload; the port's
config loads every plane the reference's does, the lock-order monitor
last.
"""

import contextlib
import dataclasses
import sys

import pytest

import test_codec
import test_mesh
from tpukube.core import codec as ref_codec
from tpukube.core.clock import FakeClock as RefFakeClock
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.mesh import MeshSpec as RefMeshSpec
from tpukube.core.mesh import factor_shapes as ref_factor_shapes
from tpukube.core.types import AllocResult as RefAllocResult
from tpukube.core.types import TopologyCoord as RefCoord
from tpukube.device import TpuDeviceManager
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sched.shard import _free_port as RefFreePort
from tpukube_torch.core import codec
from tpukube_torch.core.clock import FakeClock
from tpukube_torch.core.config import load_config
from tpukube_torch.core.mesh import MeshSpec, factor_shapes
from tpukube_torch.core.types import AllocResult, TopologyCoord
from tpukube_torch.device import GpuDeviceManager
from torch_refnative import use_private_tpuinfo
from torch_twin import run_twin, reference_tests

use_private_tpuinfo()


@pytest.mark.parametrize("fn", reference_tests(test_mesh, {}) + reference_tests(test_codec, {}),
                         ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_reference_core_tests_hold_on_the_port(fn):
    run_twin(fn)


def _body_import_of_extender(seen):
    # a reference test's body import: the port's run must reach the port
    from tpukube.sched.extender import Extender
    from tpukube.sched.state import ClusterState
    from tpukube.core import codec as body_codec
    seen.append((Extender.__module__, ClusterState.__module__, body_codec.__name__))


def test_twin_body_imports_reach_the_port():
    seen = []
    run_twin(_body_import_of_extender, {"seen": lambda g: contextlib.nullcontext(seen)})
    assert seen == [
        ("tpukube.sched.extender", "tpukube.sched.state", "tpukube.core.codec"),
        ("tpukube_torch.sched.extender", "tpukube_torch.sched.state",
         "tpukube_torch.core.codec")]


# reached through a container, as a helper of another module would hold
# it, the reference's class is not remapped: building it must fail
_HELD = {"Extender": RefExtender}


def _builds_a_reference_extender():
    _HELD["Extender"](ref_load_config(env={}))


def _imports_what_the_port_lacks():
    # the port's discovery shim is native/gpuinfo.py: no tpuinfo module
    from tpukube.native.tpuinfo import TpuInfoError  # noqa: F401


def _uses_a_global_the_port_lacks():
    # the port's workers bind port 0 and report it: no free-port probe
    assert RefFreePort() > 0


@pytest.mark.parametrize("fn,error,match", [
    (_builds_a_reference_extender, AssertionError, "built the reference's Extender"),
    (_imports_what_the_port_lacks, ImportError,
     "no module tpukube_torch.native.tpuinfo"),
    (_uses_a_global_the_port_lacks, AssertionError,
     "no tpukube_torch.sched.shard._free_port"),
])
def test_twin_port_run_cannot_fall_back_to_the_reference(fn, error, match):
    with pytest.raises(error, match=match):
        run_twin(fn)
    # the reference's classes and modules are whole again afterwards
    RefExtender(ref_load_config(env={}))
    assert sys.modules["tpukube.sched.extender"].Extender is RefExtender


def test_hgx_fleet_geometry():
    # 16 HGX hosts of 8 GPUs along y: a host is one x-row, and an
    # (8, k, 1) box is k whole hosts
    m = MeshSpec(dims=(8, 16, 1), host_block=(8, 1, 1))
    ref = RefMeshSpec(dims=(8, 16, 1), host_block=(8, 1, 1))
    assert (m.num_chips, m.chips_per_host, m.num_hosts, m.host_grid) == (
        128, 8, 16, (1, 16, 1))
    assert m.all_hosts() == ref.all_hosts()
    assert m.host_of(TopologyCoord(5, 3, 0)) == "host-0-3-0"
    assert m.coords_of_host("host-0-3-0") == [TopologyCoord(x, 3, 0) for x in range(8)]
    assert factor_shapes(64, m.dims) == ref_factor_shapes(64, ref.dims)
    assert (8, 8, 1) in factor_shapes(64, m.dims)


@pytest.mark.parametrize("host", ["host-0-0-0", "host-0-2-0"])
@pytest.mark.parametrize("faults", [(), ((3, False),)])
def test_node_agents_annotate_alike(host, faults):
    env = {
        "TPUKUBE_BACKEND": "sim",
        "TPUKUBE_SIM_MESH_DIMS": "8,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "8,1,1",
        "TPUKUBE_HBM_BYTES_PER_CHIP": str(80 << 30),
        "TPUKUBE_CORES_PER_CHIP": "132",
    }
    with TpuDeviceManager(ref_load_config(env=env), host=host) as ref, \
            GpuDeviceManager(load_config(env=env), host=host) as port:
        for index, healthy in faults:
            ref.inject_fault(index, healthy)
            port.inject_fault(index, healthy)
        want = ref_codec.annotate_node(ref.node_info(), ref.mesh)
        got = codec.annotate_node(port.node_info(), port.mesh)
    assert got == want
    node, mesh = codec.decode_node_topology(got[codec.ANNO_NODE_TOPOLOGY])
    assert node.name == host and mesh.dims == (8, 4, 1)


def test_alloc_payload_is_the_reference_s():
    args = dict(pod_key="default/m-0", node_name="host-0-1-0",
                device_ids=["tpu-0", "tpu-1"], env={"TPU_KUBE_GANG_NUM_SLICES": "1"},
                priority=3, uid="uid-default-m-0")
    got = codec.encode_alloc(AllocResult(
        coords=[TopologyCoord(0, 1, 0), TopologyCoord(1, 1, 0)], **args))
    want = ref_codec.encode_alloc(RefAllocResult(
        coords=[RefCoord(0, 1, 0), RefCoord(1, 1, 0)], **args))
    assert got == want
    back = ref_codec.decode_alloc(got)
    assert dataclasses.asdict(codec.decode_alloc(want)) == dataclasses.asdict(back)


def test_fake_clock_fires_timers_as_the_reference():
    fired, ref_fired = [], []
    clocks = ((FakeClock(), fired), (RefFakeClock(), ref_fired))
    for clock, out in clocks:
        for delay, tag in ((2.0, "b"), (1.0, "a"), (2.0, "c"), (5.0, "late")):
            clock.schedule(delay, lambda t=tag, c=clock, o=out: o.append((t, c.monotonic())))
        clock.advance(3.0)
        out.append(("now", clock.monotonic(), clock.time(), clock.pending_timers()))
    assert fired == ref_fired
    assert fired[:3] == [("a", 1.0), ("b", 2.0), ("c", 2.0)]
    with pytest.raises(ValueError):
        FakeClock().advance(-1)


def test_config_defaults_are_the_reference_s():
    cfg, ref = load_config(env={}), ref_load_config(env={})
    for name in ("resource_tpu", "resource_vtpu", "extender_host", "extender_port",
                 "score_mode", "reservation_ttl_seconds", "trace_capacity",
                 "trace_sink_max_bytes", "events_capacity", "events_sink_max_bytes",
                 "snapshot_audit_rate", "snapshot_delta_enabled",
                 "bulk_ingest_enabled"):
        assert getattr(cfg, name) == getattr(ref, name), name
    env = {"TPUKUBE_SNAPSHOT_DELTA_ENABLED": "0", "TPUKUBE_SCORE_MODE": "binpack",
           "TPUKUBE_RESERVATION_TTL_SECONDS": "0.5"}
    got, want = load_config(env=env), ref_load_config(env=env)
    assert (got.snapshot_delta_enabled, got.score_mode, got.reservation_ttl_seconds) == (
        want.snapshot_delta_enabled, want.score_mode, want.reservation_ttl_seconds)
    with pytest.raises(ValueError, match="score_mode"):
        load_config(env={"TPUKUBE_SCORE_MODE": "random"})


@pytest.mark.parametrize("key,value", [
    ("TPUKUBE_LOCK_MONITOR", "1"),
])
def test_once_refused_lock_monitor_loads_and_builds(key, value):
    # refused until the lock-order monitor was ported: on, it loads as the
    # reference's does, and a SimCluster built from it installs the
    # monitor (the threading factories patched for its life, restored by
    # its stop)
    import threading

    from tpukube_torch.analysis import lockgraph
    from tpukube_torch.sim import SimCluster

    cfg, ref = load_config(env={key: value}), ref_load_config(env={key: value})
    assert cfg.lock_monitor is ref.lock_monitor is True
    assert load_config(env={key: "0"}).lock_monitor is False
    with SimCluster(cfg) as c:
        assert c.lock_monitor is not None
        assert lockgraph.active() is c.lock_monitor
        assert threading.Lock is not lockgraph._REAL_LOCK
        c.schedule(c.make_pod("p0", tpu=1))
        rep = c.lock_monitor.report()
    assert rep["cycles"] == [] and rep["acquisitions"] > 0
    assert threading.Lock is lockgraph._REAL_LOCK
    assert lockgraph.active() is None


@pytest.mark.parametrize("key,value", [
    ("TPUKUBE_PLANNER_REPLICAS", "2"),
    ("TPUKUBE_GENERATION_LOG_CAPACITY", "65536"),
])
def test_once_refused_shard_planes_load_and_build(key, value):
    # refused until the in-process shard router and the incremental
    # resync log were ported: on, each loads as the reference's does
    # and builds its plane (a ShardRouter over two replicas; the
    # ledger's change log, whose allocs_since answers a cursor)
    from tpukube_torch.sched.extender import Extender
    from tpukube_torch.sched.shard import ShardRouter

    cfg, ref = load_config(env={key: value}), ref_load_config(env={key: value})
    name = key[len("TPUKUBE_"):].lower()
    assert getattr(cfg, name) == getattr(ref, name) == int(value)
    if name == "planner_replicas":
        router = ShardRouter(cfg)
        try:
            assert len(router.replicas) == 2
            assert all(r.extender is not None for r in router.replicas)
        finally:
            router.shutdown()
        return
    state = Extender(cfg).state
    assert state.allocs_since(None)["full"] == []
    state.set_generation_log(0)
    assert state.allocs_since(None) is None
    with pytest.raises(ValueError, match="generation_log_capacity"):
        load_config(env={key: "-1"})


@pytest.mark.parametrize("key,plane", [
    ("TPUKUBE_CAPACITY_ENABLED", "capacity"),
    ("TPUKUBE_DRAIN_ENABLED", "drain"),
    ("TPUKUBE_AUTOSCALE_ENABLED", "autoscaler"),
    ("TPUKUBE_DECISIONS_ENABLED", "decisions"),
])
def test_once_refused_elasticity_planes_load_and_build(key, plane):
    # refused until capacity, drain, the autoscaler and decision
    # provenance were ported: on, each builds its plane on the extender
    # as the reference's does (the autoscaler with drain, which it
    # requires); off, none is built
    from tpukube_torch.sched.extender import Extender

    env = {key: "1"}
    if plane == "autoscaler":
        env["TPUKUBE_DRAIN_ENABLED"] = "1"
    on, off = (Extender(load_config(env=e)) for e in (env, {key: "0"}))
    assert getattr(on, plane) is not None
    assert getattr(off, plane) is None
    assert getattr(load_config(env=env), key[len("TPUKUBE_"):].lower())
