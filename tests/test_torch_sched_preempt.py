"""The port's preemption, eviction executor, pod-lifecycle loop and
``/metrics`` held against the reference's: the reference's config-5,
config-6, apiserver, termination-gate, multi-slice, registry and backoff
tests run on both packages decision by decision; ``chip_smoke.py``'s
config-5 sequence on an HGX fleet and its one-node preemption sequence
make the same decisions on both; and the port's ``/metrics`` renders what
the reference renders for the same history."""

import contextlib
import json
import time
import types

import pytest

import chip_smoke
import test_advice_round5
import test_apiserver
import test_config5
import test_config6
import test_multislice
import test_obs
import test_retry
from tpukube import apiserver as ref_apiserver
from tpukube.core import codec as ref_codec
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.mesh import MeshSpec as RefMeshSpec
from tpukube.core.types import ChipInfo as RefChipInfo
from tpukube.core.types import NodeInfo as RefNodeInfo
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.core.types import TopologyCoord as RefTopologyCoord
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch import apiserver
from tpukube_torch.core import codec
from tpukube_torch.core.config import load_config
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import ChipInfo, NodeInfo, PodGroup, TopologyCoord
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sched.kube import pod_object
from tpukube_torch.sim import SimCluster
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()


def _module_fixture(module, name: str, before=()):
    """A reference module's fixture as a twin fixture: its body rebuilt
    over the twin run's remapped globals (so it builds the port's sim in
    the port's run), after which the named tests of the same module run
    on the yielded object first (a module-scoped fixture's history)."""
    body = vars(module)[name]._get_wrapped_function()

    @contextlib.contextmanager
    def fixture(g):
        gen = contextlib.contextmanager(
            types.FunctionType(body.__code__, g, body.__name__))
        with gen() as obj:
            for test in before:
                g[test](obj)
            yield obj
    return fixture


# test_config5's ``loaded_cluster`` is module-scoped: its second test reads
# the cluster the first one left
CONFIG5_FIXTURES = {
    "test_config5_multi_tenant_preemption_and_utilization": {
        "loaded_cluster": _module_fixture(test_config5, "loaded_cluster")},
    "test_config5_low_priority_gang_cannot_preempt": {
        "loaded_cluster": _module_fixture(
            test_config5, "loaded_cluster",
            before=("test_config5_multi_tenant_preemption_and_utilization",))},
}


@pytest.mark.parametrize("fn", reference_tests(test_config5, {}),
                         ids=lambda f: f.__name__)
def test_reference_config5_tests_hold_on_the_port(fn):
    # the reference's sim serves HTTP: the first test scrapes its /metrics
    run_twin(fn, CONFIG5_FIXTURES.get(fn.__name__), serve_ref=True)


CONFIG6_SKIPS = {
    "test_churn_scenario_emits_stability_metrics":
        "drives the reference's scenarios module (not ported)",
}


@pytest.mark.parametrize("fn", reference_tests(test_config6, CONFIG6_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_config6_tests_hold_on_the_port(fn):
    run_twin(fn, {"churned": _module_fixture(test_config6, "churned")})


_REST = "RestApiServer (the Kubernetes REST channel) is not ported"
_INTENTS = "the alloc-intent watcher (AllocIntentWatcher) is not ported"
_EFFECTOR = "the bind effector (pod_binder) is not ported"
_REFRESH = "NodeTopologyRefreshLoop is not ported"
APISERVER_SKIPS = {
    "test_extender_learns_topology_only_through_syncer":
        "NodeAnnotationSyncer is not ported",
    "test_syncer_tolerates_missing_and_garbage_file":
        "NodeAnnotationSyncer is not ported",
    "test_rest_apiserver_speaks_merge_patch": _REST,
    "test_rest_list_pods_paginates": _REST,
    "test_intent_watcher_feeds_pod_allocs": _INTENTS,
    "test_kubelet_divergence_reconciles_extender_ledger":
        "the alloc-intent watcher and the reconcile loop are not ported",
    "test_reconcile_refuses_chips_held_by_another_pod":
        "device-id reconcile is not ported",
    "test_reconcile_updates_gang_assignment": "device-id reconcile is not ported",
    "test_rest_eviction_subresource": _REST,
    "test_gang_bind_waits_for_graceful_victim_termination":
        "reads /state/gangs (gang_snapshot) and trace replay, not ported; "
        "its sequence is held against the reference here "
        "(test_graceful_victims_gate_the_gang_as_the_reference)",
    "test_reconcile_loop_watch_mode_folds_report_on_event":
        "the reconcile loop and the bind effector are not ported",
    "test_bind_effector_creates_real_binding": _EFFECTOR,
    "test_bind_effector_failure_rolls_back_ledger": _EFFECTOR,
    "test_rest_bind_pod_posts_binding_subresource": _REST,
    "test_bind_effector_failure_uncommits_quorum": _EFFECTOR,
    "test_lifecycle_watch_mode_releases_on_delete":
        _EFFECTOR + "; the watch mode is held against the reference here "
        "(test_lifecycle_watch_releases_on_delete_as_the_reference)",
    "test_rest_watch_pods_streams_events": _REST,
    "test_intent_watcher_watch_mode": _INTENTS,
    "test_watch_event_semantics": _INTENTS,
    "test_watch_stop_interrupts_blocked_stream": _INTENTS,
    "test_health_transition_reannotates_node":
        "NodeAnnotationSyncer is not ported",
    "test_node_refresh_loop_feeds_namescapable_cache": _REFRESH,
    "test_node_refresh_watch_mode_applies_fault_within_event": _REFRESH,
    "test_rebuild_primes_refresh_loop": _REFRESH,
    "test_concurrent_binds_with_flaky_binder": _EFFECTOR,
    "test_intent_watcher_watch_mode_over_fake_api": _INTENTS,
}


@pytest.mark.parametrize("fn", reference_tests(test_apiserver, APISERVER_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_apiserver_tests_hold_on_the_port(fn):
    run_twin(fn, TMP_PATH)


ADVICE_SKIPS = {
    "test_watch_alive_consults_informer_host_stream":
        "PodInformer (the shared pod informer) is not ported",
}
MULTISLICE_SKIPS = {
    "test_snapshot_reports_slices":
        "reads /state/topology (topology_snapshot), not ported",
    "test_replay_determinism_with_multislice_gang": "trace replay is not ported",
}


@pytest.mark.parametrize(
    "fn",
    reference_tests(test_advice_round5, ADVICE_SKIPS)
    + reference_tests(test_multislice, MULTISLICE_SKIPS),
    ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_reference_termination_and_multislice_tests_hold_on_the_port(fn):
    # terminating victims in the preemption planner and the executor's
    # races; gangs and per-slice preemption on multi-slice fleets
    run_twin(fn)


# the registry's own tests and the extender exposition's golden page
OBS_TESTS = (
    "test_registry_counter_gauge_labels_and_order",
    "test_registry_label_escaping",
    "test_registry_duplicate_name_rejected",
    "test_histogram_bucket_boundaries",
    "test_histogram_buckets_are_monotonic_counters",
    "test_summary_quantiles_and_count_sum",
    "test_extender_metrics_byte_compat_golden",
    "test_registry_help_lines_opt_in",
)


@pytest.mark.parametrize("name", OBS_TESTS)
def test_reference_registry_tests_hold_on_the_port(name):
    run_twin(vars(test_obs)[name])


# the reconnect backoff the watch loop paces itself with, the Retrier the
# plugin's kubelet registration runs under, and the config's retry_* knobs
# (the rest of test_retry is the reference's CircuitBreaker, not ported,
# and the config tests that read its circuit_*/chaos_seed knobs)
RETRY_TESTS = (
    "test_delay_is_exponential_and_capped",
    "test_delay_jitter_only_shrinks_and_is_seeded",
    "test_backoff_sequence_grows_and_resets",
    "test_retrier_retries_then_succeeds",
    "test_retrier_exhausts_max_attempts_and_journals",
    "test_retrier_honors_overall_deadline",
    "test_retrier_does_not_retry_non_retryable",
    "test_retrier_custom_classifier",
)


@pytest.mark.parametrize("name", RETRY_TESTS)
def test_reference_backoff_tests_hold_on_the_port(name):
    run_twin(vars(test_retry)[name])


# test_config_rejects_bad_retry_knobs's cases of the retry_* knobs
RETRY_KNOB_CASES = [
    env for env in
    test_retry.test_config_rejects_bad_retry_knobs.pytestmark[0].args[1]
    if all(k.startswith("TPUKUBE_RETRY_") for k in env)
]


@pytest.mark.parametrize("env", RETRY_KNOB_CASES, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()))
def test_reference_retry_knob_checks_hold_on_the_port(env):
    run_twin(test_retry.test_config_rejects_bad_retry_knobs,
             {"env": lambda g: contextlib.nullcontext(env)})


def test_policy_from_config_reads_the_retry_knobs():
    # test_retry's test_policy_from_config_defaults and
    # test_config_retry_knobs_load_and_coerce, minus their circuit_* and
    # chaos_seed knobs (the CircuitBreaker's, not ported)
    from tpukube.core import retry as ref_retry
    from tpukube_torch.core import retry

    env = {"TPUKUBE_RETRY_MAX_ATTEMPTS": "7",
           "TPUKUBE_RETRY_BASE_DELAY_SECONDS": "0.25",
           "TPUKUBE_RETRY_JITTER": "0.1",
           "TPUKUBE_RETRY_ATTEMPT_TIMEOUT_SECONDS": "2.5"}
    for e in ({}, env):
        got = retry.policy_from_config(load_config(env=e))
        want = ref_retry.policy_from_config(ref_load_config(env=e))
        assert vars(got) == vars(want)
    assert retry.policy_from_config(load_config(env={})) == retry.RetryPolicy()


# -- chip_smoke's config 5 (step 11a), both packages -------------------------

@pytest.fixture(scope="module")
def config5_runs():
    port = chip_smoke.config5_fleet(SimCluster, load_config, PodGroup)
    ref = chip_smoke.config5_fleet(RefSimCluster, ref_load_config, RefPodGroup)
    return port, ref


def test_config5_on_an_hgx_fleet_decides_as_the_reference(config5_runs):
    port, ref = config5_runs
    for key in ("burst", "gang", "refill", "victims", "evicted", "still_stored",
                "preemptions", "util_burst", "utilization", "committed",
                "refused", "hosts"):
        assert port[key] == ref[key], key
    # the contract chip_smoke holds the port's run to
    coords = {c for _, _, cs in port["gang"] for c in cs}
    nodes = sorted({n for n, _, _ in port["gang"]})
    ys = sorted({c[1] for c in coords})
    assert len(coords) == 64 and len(nodes) == 8
    assert all(set(port["hosts"][n]) <= coords for n in nodes)
    assert ys == list(range(ys[0], ys[0] + 8))
    assert port["preemptions"] == len(port["victims"]) == 16
    assert port["evicted"] == port["victims"]  # eviction order included
    assert port["still_stored"] == []
    assert port["utilization"] >= 0.95
    assert "cannot preempt" in port["refused"]


def _page(text: str) -> tuple[dict, dict]:
    """(family -> TYPE, series -> value) of a Prometheus text page."""
    types_ = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types_[name] = kind
    return types_, chip_smoke.metric_lines(text)


# reference families with no source in the port (ROADMAP.md): the snapshot
# cache's stats, per-slice fragmentation, bulk ingest, incremental resync
REFERENCE_ONLY = {
    "tpukube_snapshot_rebuilds_total", "tpukube_snapshot_hits_total",
    "tpukube_snapshot_rebuild_seconds", "tpukube_snapshot_delta_applies_total",
    "tpukube_snapshot_delta_overflows_total",
    "tpukube_snapshot_delta_apply_seconds", "tpukube_slice_fragmentation",
    "tpukube_slice_largest_free_box_chips", "tpukube_ingest_nodes_total",
    "tpukube_ingest_seconds", "tpukube_resync_full_total",
    "tpukube_resync_incremental_total", "tpukube_resync_bytes_total",
}


def test_config5_metrics_render_as_the_reference(config5_runs):
    port, ref = config5_runs
    ptypes, psamples = _page(port["metrics"])
    rtypes, rsamples = _page(ref["metrics"])
    # every family the port renders, under the reference's name and TYPE
    assert {f: rtypes.get(f) for f in ptypes} == ptypes
    assert set(rtypes) - set(ptypes) == REFERENCE_ONLY
    # every series the port renders, with the reference's labels
    assert set(psamples) <= set(rsamples)
    # count-valued series are equal; timings (latency windows, buckets of
    # a latency histogram, the eviction age) are the host's, not decisions
    counts = [k for k in psamples
              if "seconds" not in k or k.split("{")[0].endswith("_count")]
    assert {k: psamples[k] for k in counts} == {k: rsamples[k] for k in counts}
    for key in ("tpu_chip_utilization_percent", "tpukube_preemptions_total",
                "tpukube_evictions_total", "tpukube_binds_total",
                'tpukube_events_total{reason="VictimGone"}'):
        assert key in counts
    assert psamples["tpu_chip_utilization_percent"] >= 95.0
    assert 0 < psamples['gang_schedule_latency_seconds{quantile="0.5"}'] < 60
    assert psamples["tpukube_preemptions_total"] == 16


# -- chip_smoke's one-node preemption (step 11b), both packages --------------

PORT = types.SimpleNamespace(
    Extender=Extender, load_config=load_config, codec=codec, api=apiserver,
    PodGroup=PodGroup, NodeInfo=NodeInfo, ChipInfo=ChipInfo, MeshSpec=MeshSpec,
    TopologyCoord=TopologyCoord, SimCluster=SimCluster, sim_kw={})
REF = types.SimpleNamespace(
    Extender=RefExtender, load_config=ref_load_config, codec=ref_codec,
    api=ref_apiserver, PodGroup=RefPodGroup, NodeInfo=RefNodeInfo,
    ChipInfo=RefChipInfo, MeshSpec=RefMeshSpec, TopologyCoord=RefTopologyCoord,
    SimCluster=RefSimCluster, sim_kw={"in_process": True})


def _one_gpu_node(pkg) -> list:
    """The node object of a one-GPU node agent, as chip_smoke's card
    machine annotates its H100 (a 1,1,1 mesh)."""
    chip = pkg.ChipInfo(chip_id="GPU-0", index=0, coord=pkg.TopologyCoord(0, 0, 0),
                        hbm_bytes=80 << 30, num_cores=132)
    info = pkg.NodeInfo(name="gpu-node", chips=[chip])
    mesh = pkg.MeshSpec((1, 1, 1), (1, 1, 1))
    return [{"metadata": {"name": "gpu-node",
                          "annotations": pkg.codec.annotate_node(info, mesh)}}]


def _sim_nodes(pkg) -> list:
    """A 4,4,1 fleet of 2,2,1 hosts (test_apiserver's), with the
    reference's default chip size on both packages."""
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1"}
    with pkg.SimCluster(pkg.load_config(env=env), **pkg.sim_kw) as c:
        return c.node_objects()


def _gated_preemption(pkg, nodes, n_burst, members, finish_in):
    """Burst pods (priority 0, one GPU each) fill the nodes through the
    webhooks; a priority-100 gang of ``members`` is planned over them.
    Its binds must wait for every victim: the executor evicts them
    gracefully (objects linger, deletionTimestamp stamped), and the
    victims finish terminating in the groups ``finish_in`` gives, one
    group per executor pass. Returns every webhook response, executor
    result and count, in order."""
    ext = pkg.Extender(pkg.load_config(env={}))
    api = pkg.api.FakeApiServer()
    ext.evict_precheck = lambda key: api.evict_pod(*key.split("/", 1), dry_run=True)
    execu = pkg.api.EvictionExecutor(ext, api, poll_seconds=999)
    log = []

    def cycle(pod):
        fres = ext.handle("filter", {"Pod": pod, "Nodes": {"Items": nodes}})
        log.append(fres)
        if fres.get("Error") or not fres["NodeNames"]:
            return None
        pres = ext.handle("prioritize", {"Pod": pod, "NodeNames": fres["NodeNames"]})
        log.append(pres)
        scores = {e["Host"]: e["Score"] for e in pres}
        best = max(sorted(scores), key=lambda h: scores[h])
        meta = pod["metadata"]
        return {"PodName": meta["name"], "PodNamespace": meta["namespace"],
                "PodUID": meta["uid"], "Node": best}

    for i in range(n_burst):
        pod = pod_object(f"burst-{i}", tpu=1)
        bind = cycle(pod)
        bres = ext.handle("bind", bind)
        log.append(bres)
        pod["metadata"]["annotations"].update(bres["Annotations"])
        pod["spec"]["nodeName"] = bind["Node"]
        api.upsert_pod(pod)
        api.graceful.add(f"default/burst-{i}")
    group = pkg.PodGroup("llama-train", min_member=members)
    gang = pod_object("llama-train-0", tpu=1, priority=100,
                      annotations=pkg.codec.pod_group_annotations(group))
    bind = cycle(gang)
    log.append(ext.handle("bind", bind))  # executes the plan
    victims = sorted(ext.pending_evictions)
    for group_of_victims in finish_in:
        log.append(("drain", execu.drain(), execu.evicted, execu.depth()))
        log.append(("terminating", ext.gang.terminating_pod_keys(),
                    ext.gang.terminating_count()))
        log.append(ext.handle("bind", bind))
        for key in victims[group_of_victims]:
            api.finish_termination(*key.split("/", 1))
    log.append(("drain", execu.drain(), execu.evicted, execu.depth()))
    log.append(ext.handle("bind", bind))
    log.append(("end", victims, ext.preemptions, ext.binds_total,
                sorted(p["metadata"]["name"] for p in api.list_pods())))
    return log


def test_single_node_preemption_decides_as_the_reference():
    # chip_smoke's step 11b: one burst pod on the card's one GPU; the
    # victim terminates after one executor pass
    got = _gated_preemption(PORT, _one_gpu_node(PORT), 1, 1, [slice(0, 1)])
    want = _gated_preemption(REF, _one_gpu_node(REF), 1, 1, [slice(0, 1)])
    assert json.dumps(got) == json.dumps(want)
    first, gated, landed = got[-7], got[-4], got[-2]
    assert "finish terminating" in first["Error"]
    assert got[-6] == ("drain", [], 0, 1)  # accepted, still terminating
    assert got[-5] == ("terminating", ["default/burst-0"], 1)
    assert "victim" in gated["Error"]
    assert got[-3] == ("drain", ["default/burst-0"], 1, 0)
    assert not landed.get("Error")
    alloc = codec.decode_alloc(landed["Annotations"][codec.ANNO_ALLOC])
    assert (alloc.device_ids, alloc.node_name) == (["tpu-0"], "gpu-node")
    assert got[-1] == ("end", ["default/burst-0"], 1, 2, [])


def test_graceful_victims_gate_the_gang_as_the_reference():
    # test_apiserver's graceful-termination capstone: 16 burst pods, a
    # 4-member gang; two victims finish, then the other two
    got = _gated_preemption(PORT, _sim_nodes(PORT), 16, 4,
                            [slice(0, 0), slice(0, 2), slice(2, 4)])
    want = _gated_preemption(REF, _sim_nodes(REF), 16, 4,
                             [slice(0, 0), slice(0, 2), slice(2, 4)])
    assert json.dumps(got) == json.dumps(want)
    drains = [e for e in got if isinstance(e, tuple) and e[0] == "drain"]
    assert [d[2] for d in drains] == [0, 0, 2, 4]
    binds = [e for e in got if isinstance(e, dict) and "Error" in e][-5:]
    assert all("terminating" in b["Error"] for b in binds[:4])
    assert not binds[4]["Error"]
    assert got[-1][2] == 4 and len(got[-1][4]) == 12


# -- the lifecycle loop's watch mode, both packages ---------------------------

def _watch_release(sim_cls, load, api_mod, kw):
    cfg = load(env={"TPUKUBE_SIM_MESH_DIMS": "2,2,1",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"})
    with sim_cls(cfg, **kw) as c:
        api = api_mod.FakeApiServer()
        pod = c.make_pod("w0", tpu=1)
        c.schedule(pod)
        api.upsert_pod(pod)
        loop = api_mod.PodLifecycleReleaseLoop(c.extender, api, poll_seconds=0.05)
        assert loop._use_watch
        loop.start()
        try:
            deadline = time.monotonic() + 5
            while not loop.stream_connected() and time.monotonic() < deadline:
                time.sleep(0.01)
            api.delete_pod("default", "w0")
            while (time.monotonic() < deadline
                   and c.extender.state.allocation("default/w0")):
                time.sleep(0.01)
            return (c.extender.state.allocation("default/w0"), loop.released,
                    loop.watch_status()["mode"], c.utilization())
        finally:
            loop.stop()


def test_lifecycle_watch_releases_on_delete_as_the_reference():
    got = _watch_release(SimCluster, load_config, apiserver, {})
    want = _watch_release(RefSimCluster, ref_load_config, ref_apiserver,
                          {"in_process": True})
    assert got == want == (None, 1, "watch", 0.0)
