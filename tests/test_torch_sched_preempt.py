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


@pytest.mark.parametrize("fn", reference_tests(test_config6, {}),
                         ids=lambda f: f.__name__)
def test_reference_config6_tests_hold_on_the_port(fn):
    run_twin(fn, {"churned": _module_fixture(test_config6, "churned")})


APISERVER_SKIPS: dict[str, str] = {}


@pytest.mark.parametrize("fn", reference_tests(test_apiserver, APISERVER_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_apiserver_tests_hold_on_the_port(fn):
    # threads race each other's binds there: compare the chips taken
    run_twin(fn, TMP_PATH,
             ordered=fn.__name__ != "test_concurrent_binds_with_flaky_binder")


ADVICE_SKIPS: dict[str, str] = {}
MULTISLICE_SKIPS: dict[str, str] = {}


@pytest.mark.parametrize(
    "fn",
    reference_tests(test_advice_round5, ADVICE_SKIPS)
    + reference_tests(test_multislice, MULTISLICE_SKIPS),
    ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_reference_termination_and_multislice_tests_hold_on_the_port(fn):
    # terminating victims in the preemption planner and the executor's
    # races; gangs and per-slice preemption on multi-slice fleets
    run_twin(fn)


# the registry's own tests, the extender exposition's golden page, scenario
# 5's phase stats and the 16-pod gang's span chains. Left out:
# test_bench_process_stats_and_churn_phases, which imports the reference's
# bench.py (the port has no bench harness yet).
# test_timeline_tolerates_span_only_pods, which ends in ``obs timeline``,
# is twinned in tests/test_torch_cli.py
OBS_TESTS = (
    "test_registry_counter_gauge_labels_and_order",
    "test_registry_label_escaping",
    "test_registry_duplicate_name_rejected",
    "test_histogram_bucket_boundaries",
    "test_histogram_buckets_are_monotonic_counters",
    "test_summary_quantiles_and_count_sum",
    "test_extender_metrics_byte_compat_golden",
    "test_registry_help_lines_opt_in",
    "test_bench_line_gains_phase_stats",
    "test_timeline_span_chain_for_16_pod_gang",
)


@pytest.mark.parametrize("name", OBS_TESTS)
def test_reference_registry_tests_hold_on_the_port(name):
    run_twin(vars(test_obs)[name], TMP_PATH)


def test_timeline_of_a_torn_capture_matches_the_reference():
    # test_timeline_tolerates_span_only_pods' events: a full chain, a pod
    # with spans only, and the junk a torn capture holds
    from tpukube.obs import timeline as ref_timeline
    from tpukube_torch.obs import timeline

    now = 1_700_000_000.0
    events = [
        {"seq": 1, "ts": now, "kind": "filter",
         "request": {"Pod": {"metadata": {"name": "ok", "namespace": "default"}}},
         "response": {"NodeNames": ["n1"], "FailedNodes": {}}},
        {"seq": 2, "ts": now + 0.01, "kind": "bind",
         "request": {"PodName": "ok", "PodNamespace": "default"}, "response": {}},
        {"seq": 3, "ts": now + 0.02, "kind": "span",
         "request": {"name": "gang_reserve", "pod_key": "default/crashed",
                     "gang": "default/g"}, "response": None},
        {"seq": 4, "ts": now + 0.03, "kind": "span",
         "request": {"name": "allocate", "pod_key": "default/crashed",
                     "devices": ["tpu-0"]}, "response": None},
        "not even a dict",
        {"seq": 5, "kind": "span"},
        {"seq": 6, "ts": "corrupt", "kind": "bind"},
        {"seq": 7, "ts": now + 0.04, "kind": "span", "request": None},
    ]
    for fn in ("correlate", "span_chains", "chrome_trace", "phase_stats"):
        assert getattr(timeline, fn)(events) == getattr(ref_timeline, fn)(events), fn
    assert timeline.span_chains(events)["default/crashed"] == ["gang_reserve",
                                                                "allocate"]
    assert timeline.phase_stats(events)["allocate"]["p50_ms"] is not None


# test_retry's tests of the reconnect backoff, the Retrier, the
# CircuitBreaker, the REST channel's transport timeout and the config's
# retry_*/circuit_* knobs and chaos_seed
RETRY_TESTS = (
    "test_delay_is_exponential_and_capped",
    "test_delay_jitter_only_shrinks_and_is_seeded",
    "test_backoff_sequence_grows_and_resets",
    "test_retrier_retries_then_succeeds",
    "test_retrier_exhausts_max_attempts_and_journals",
    "test_retrier_honors_overall_deadline",
    "test_retrier_does_not_retry_non_retryable",
    "test_retrier_custom_classifier",
    "test_breaker_opens_after_consecutive_failures",
    "test_breaker_half_open_probe_closes_on_success",
    "test_breaker_half_open_probe_failure_reopens",
    "test_breaker_disabled_at_zero_threshold",
    "test_breaker_state_codes",
    "test_retrier_with_circuit_fails_fast_once_open",
    "test_retrier_non_retryable_answers_do_not_trip_circuit",
    "test_aborted_probe_releases_the_half_open_slot",
    "test_retrier_aborted_probe_releases_the_slot",
    "test_breaker_call_wrapper_counts_outcomes",
    "test_attempt_timeout_caps_rest_transport_timeout",
    "test_policy_from_config_defaults",
    "test_config_retry_knobs_load_and_coerce",
)


@pytest.mark.parametrize("name", RETRY_TESTS)
def test_reference_backoff_tests_hold_on_the_port(name):
    run_twin(vars(test_retry)[name])


# test_config_rejects_bad_retry_knobs's cases: the retry_*, circuit_* and
# chaos_seed knobs
RETRY_KNOB_CASES = (
    test_retry.test_config_rejects_bad_retry_knobs.pytestmark[0].args[1])


@pytest.mark.parametrize("env", RETRY_KNOB_CASES, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()))
def test_reference_retry_knob_checks_hold_on_the_port(env):
    run_twin(test_retry.test_config_rejects_bad_retry_knobs,
             {"env": lambda g: contextlib.nullcontext(env)})


def test_policy_from_config_reads_the_retry_knobs():
    # every retry/circuit/chaos knob against the reference's loader
    from tpukube.core import retry as ref_retry
    from tpukube_torch.core import retry

    env = {"TPUKUBE_RETRY_MAX_ATTEMPTS": "7",
           "TPUKUBE_RETRY_BASE_DELAY_SECONDS": "0.25",
           "TPUKUBE_RETRY_JITTER": "0.1",
           "TPUKUBE_RETRY_ATTEMPT_TIMEOUT_SECONDS": "2.5",
           "TPUKUBE_CIRCUIT_FAILURE_THRESHOLD": "4",
           "TPUKUBE_CIRCUIT_RESET_SECONDS": "12",
           "TPUKUBE_CIRCUIT_HALF_OPEN_PROBES": "2",
           "TPUKUBE_CHAOS_SEED": "99"}
    knobs = ("circuit_failure_threshold", "circuit_reset_seconds",
             "circuit_half_open_probes", "chaos_seed")
    for e in ({}, env):
        cfg, ref_cfg = load_config(env=e), ref_load_config(env=e)
        got = retry.policy_from_config(cfg)
        want = ref_retry.policy_from_config(ref_cfg)
        assert vars(got) == vars(want)
        assert ([getattr(cfg, k) for k in knobs]
                == [getattr(ref_cfg, k) for k in knobs])
    assert retry.policy_from_config(load_config(env={})) == retry.RetryPolicy()
    assert load_config(env={}).circuit_failure_threshold == 0  # shipped off
    assert load_config(env=env).circuit_reset_seconds == 12.0


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


# reference families with no source in the port (ROADMAP.md): the
# incremental resync log's
# every family the reference renders, the port renders too (the resync
# series since the incremental resync log was ported)
REFERENCE_ONLY: set = set()


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
