"""The port's daemons and tools (``tpukube_torch/cli.py``), its config
files, trace loading and the extender's /state, /trace, /events and
/statusz routes, held against the reference.

Twins (``run_twin``, both packages, decision by decision): test_trace.py
whole; test_cli.py's in-process tests; test_cluster_e2e.py; test_chaos.py's
two degraded-mode tests; test_metrics.py's plugin-server and extender
endpoint tests; test_obs.py's span-only timeline test (it ends in ``obs
timeline``); test_telemetry.py's plugin /statusz test; test_ingest.py's
bulk-ingest parity tests. Left out, with the reason:
test_cli.py's ``test_scenarios_one_through_four`` (its env-key check names
``TPU_VISIBLE_DEVICES``, which the port's node agent renames
``CUDA_VISIBLE_DEVICES``: held below with that name) and
``test_extender_daemon_subprocess`` (starts the reference's module: the
port's daemon is started below); test_ingest.py's checkpoint tests
(twinned in tests/test_torch_journal.py) and its ``allocs_since`` and
resync tests (the incremental resync log, ROADMAP.md Queue 1 item 5; the
ingest halves of its two statusz/metrics tests are held below).
test_promlint.py is twinned in tests/test_torch_slo.py; the port's pages
are linted below with the port's own linter (``obs/slo.py``).

Daemons run as children of these tests (``python -m tpukube_torch.cli``),
each under its own timeout."""

import contextlib
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import time
import types
import urllib.request

import pytest

import test_chaos
import test_cli
import test_cluster_e2e
import test_ingest
import test_metrics
import test_obs
import test_telemetry
import test_trace
from tpukube import trace as ref_trace
from tpukube.core.config import load_config as ref_load_config
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch import cli, trace
from tpukube_torch.core.config import load_config, read_yaml, write_yaml
from tpukube_torch.obs.slo import parse_metrics, validate_exposition
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 20.0


@contextlib.contextmanager
def _tmp_path_factory():
    with tempfile.TemporaryDirectory() as td:
        n = iter(range(1000))
        yield types.SimpleNamespace(
            mktemp=lambda name: pathlib.Path(tempfile.mkdtemp(
                prefix=f"{name}{next(n)}", dir=td)))


class _Capture:
    def __init__(self, out, err):
        self._out, self._err = out, err

    def readouterr(self):
        got = types.SimpleNamespace(out=self._out.getvalue(),
                                    err=self._err.getvalue())
        self._out.seek(0)
        self._out.truncate()
        self._err.seek(0)
        self._err.truncate()
        return got


@contextlib.contextmanager
def _capsys():
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        yield _Capture(out, err)


def _twin_fixture(module, name, settle=None, **providers):
    """A reference module's fixture as a twin fixture: its body rebuilt
    over the twin run's globals (so it builds the port's sim in the
    port's run); ``providers`` give its own arguments. ``settle(obj)``
    runs before the test gets the object."""
    body = vars(module)[name]._get_wrapped_function()

    @contextlib.contextmanager
    def fixture(g):
        with contextlib.ExitStack() as stack:
            args = {k: stack.enter_context(v()) for k, v in providers.items()}
            gen = contextlib.contextmanager(
                types.FunctionType(body.__code__, g, body.__name__))
            obj = stack.enter_context(gen(**args))
            if settle is not None:
                settle(obj)
            yield obj
    return fixture


def _sink_drained(traced) -> None:
    """The module-scoped ``traced_cluster`` is built once for the whole
    module in the reference's own run, so its JSONL sink has long drained
    when test_jsonl_sink_round_trips reads it; built for each twin, wait
    for the sink's drain thread to catch up with the ring."""
    c, _, path = traced
    want = len(c.extender.trace.events())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with contextlib.suppress(OSError):
            with open(path) as f:
                if sum(1 for _ in f) >= want:
                    return
        time.sleep(0.01)


# -- trace: test_trace.py whole ----------------------------------------------

TRACE_FIXTURES = {
    "traced_cluster": _twin_fixture(test_trace, "traced_cluster",
                                    settle=_sink_drained,
                                    tmp_path_factory=_tmp_path_factory),
    **TMP_PATH,
}


@pytest.mark.parametrize("fn", reference_tests(test_trace, {}),
                         ids=lambda f: f.__name__)
def test_reference_trace_tests_hold_on_the_port(fn):
    # the reference's sim serves HTTP: /state and /trace are scraped
    run_twin(fn, TRACE_FIXTURES, serve_ref=True)


# -- the CLI: test_cli.py ------------------------------------------------------

CLI_SKIPS = {
    "test_scenarios_one_through_four":
        "checks TPU_VISIBLE_DEVICES, which the port's node agent names "
        "CUDA_VISIBLE_DEVICES: held in test_scenarios_one_through_four_on_"
        "the_port",
    "test_extender_daemon_subprocess":
        "starts the reference's module: the port's daemon is started in "
        "test_extender_daemon_serves_and_exits_clean",
}
CLI_FIXTURES = {
    "live_cluster": _twin_fixture(test_cli, "live_cluster"),
    "capsys": lambda g: _capsys(),
    **TMP_PATH,
}


@pytest.mark.parametrize("fn", reference_tests(test_cli, CLI_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_cli_tests_hold_on_the_port(fn):
    run_twin(fn, CLI_FIXTURES, serve_ref=True)


def test_scenarios_one_through_four_on_the_port():
    # test_cli's test_scenarios_one_through_four on both packages, the
    # visible-devices key under each package's name
    for n in (1, 2, 3, 4):
        got, want = scenarios.run(n), ref_scenarios.run(n)
        assert got["scenario"] == want["scenario"] == n
        if n == 1:
            assert got["devices"] == want["devices"] == ["tpu-0"]
            assert "CUDA_VISIBLE_DEVICES" in got["env_keys"]
            assert "TPU_VISIBLE_DEVICES" in want["env_keys"]
        if n == 2:
            assert len(got["placements"]) == 4
            assert got["utilization_percent"] == want["utilization_percent"] == 50.0
        if n == 3:
            assert got["shared_one_chip"] is want["shared_one_chip"] is True
            assert all(p["hbm_limit"] is not None for p in got["pods"])
        if n == 4:
            assert got["contiguous"] is want["contiguous"] is True
            assert got["utilization_percent"] == pytest.approx(100 * 24 / 64)


def test_reference_cluster_e2e_holds_on_the_port():
    run_twin(test_cluster_e2e.test_full_cluster_lifecycle, TMP_PATH)


@pytest.mark.parametrize("name", [
    "test_degraded_mode_fails_filter_and_bind_safe",
    "test_degraded_gauge_and_retry_series_render",
])
def test_reference_degraded_mode_tests_hold_on_the_port(name):
    run_twin(vars(test_chaos)[name])


@pytest.mark.parametrize("name", [
    "test_quantile_nearest_rank",
    "test_extender_metrics_endpoint",
    "test_plugin_metrics_server",
    "test_plugin_metrics_export_round2_loops",
    "test_extender_metrics_export_reconcile_and_evictions",
    "test_extender_metrics_export_round5_loops",
    "test_label_values_escaped",
])
def test_reference_metrics_server_tests_hold_on_the_port(name):
    run_twin(vars(test_metrics)[name], TMP_PATH, serve_ref=True)


def test_reference_timeline_cli_test_holds_on_the_port():
    run_twin(test_obs.test_timeline_tolerates_span_only_pods, TMP_PATH)


def test_reference_plugin_statusz_test_holds_on_the_port():
    run_twin(test_telemetry.test_plugin_statusz_telemetry_section, TMP_PATH)


# -- bulk ingest: test_ingest.py's parity tests ------------------------------

INGEST_TESTS = (
    "test_bulk_ingest_parity_mixed_payloads",
    "test_bulk_ingest_error_items_match_per_node",
    "test_bulk_ingest_batch_internal_conflict_unwinds_cleanly",
    "test_bulk_ingest_duplicate_name_in_one_batch_matches_per_node",
    "test_decode_counters_track_resend_suppression",
    "test_bulk_ingest_changed_payload_takes_per_node_path",
    "test_bulk_ingest_append_to_live_slice_advances_caches",
    "test_bulk_ingest_placement_parity_through_webhooks",
)


@pytest.mark.parametrize("name", INGEST_TESTS)
def test_reference_ingest_tests_hold_on_the_port(name):
    run_twin(vars(test_ingest)[name])


@pytest.mark.parametrize("bulk", ["1", "0"])
def test_ingest_statusz_and_series_as_the_reference(bulk):
    # the ingest halves of test_ingest's test_ingest_and_resync_statusz_
    # sections and test_ingest_resync_series_render_only_when_on, on both
    # packages (their resync halves are in tests/test_torch_resync.py)
    from tpukube.metrics import render_extender_metrics as ref_render
    from tpukube.obs.statusz import extender_statusz as ref_statusz
    from tpukube.sim import SimCluster as RefSim
    from tpukube_torch.metrics import render_extender_metrics
    from tpukube_torch.obs.statusz import extender_statusz
    from tpukube_torch.sim import SimCluster

    env = {**REF_SIM_DEFAULTS, "TPUKUBE_BULK_INGEST_ENABLED": bulk}
    docs, pages = [], []
    for sim, load, statusz, render in (
            (SimCluster, load_config, extender_statusz, render_extender_metrics),
            (RefSim, ref_load_config, ref_statusz, ref_render)):
        with sim(load(env=env)) as c:
            c.schedule(c.make_pod("p", tpu=1))
            docs.append(statusz(c.extender)["ingest"])
            pages.append(render(c.extender))
    for doc in docs:
        if bulk == "1":
            assert doc["enabled"] is True and doc["batches"] >= 1
        else:
            assert doc == {"enabled": False}
    keep = ("enabled", "nodes_total", "batches", "decode_cache_hits",
            "decode_cache_misses", "decode_cache_hit_rate")
    assert ({k: docs[0].get(k) for k in keep}
            == {k: docs[1].get(k) for k in keep})
    for page in pages:
        assert ("tpukube_ingest_nodes_total" in page) is (bulk == "1")
        assert ("tpukube_ingest_seconds" in page) is (bulk == "1")


def test_ingest_warmer_drains_the_lazy_store():
    from tpukube_torch.sched.extender import Extender

    ext = Extender(load_config(env={}))
    ext.upsert_nodes_many(test_ingest._mixed_items())
    st = ext.state
    assert st.ingest_stats()["lazy_pending"] == 0 or st._warming
    deadline = time.monotonic() + 10
    while st.ingest_stats()["lazy_pending"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert st.ingest_stats()["lazy_pending"] == 0
    assert st.warm_pending() == 0


# -- Prometheus text: the reference's linter over the port's pages ------------

def test_port_metrics_pages_lint_clean_with_the_reference_linter(tmp_path):
    # test_promlint.py's two checks (its linter lives in the reference's
    # SLO module, not ported): the extender's page after a gang, a plain
    # pod and a release; the node agent's MetricsServer page with a fault
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.metrics import MetricsServer, render_plugin_metrics
    from tpukube_torch.obs.events import EventJournal
    from tpukube_torch.obs.health import HealthSampler
    from tpukube_torch.plugin import DevicePluginServer, HealthWatcher
    from tpukube_torch.sim import SimCluster

    cfg = load_config(env={**REF_SIM_DEFAULTS,
                           "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
                           "TPUKUBE_DEVICE_PLUGIN_DIR": str(tmp_path)})
    with SimCluster(cfg) as c:
        group = PodGroup("g", min_member=4)
        for i in range(4):
            c.schedule(c.make_pod(f"g-{i}", tpu=1, group=group))
        c.schedule(c.make_pod("solo", tpu=1))
        c.delete_pod("solo")
        with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=10) as r:
            text = r.read().decode()
    assert validate_exposition(text) == []
    names = {s.name for s in parse_metrics(text)}
    for name in ("gang_schedule_latency_seconds_bucket",
                 "tpukube_webhook_latency_seconds_bucket",
                 "tpukube_events_total", "tpukube_snapshot_rebuilds_total",
                 "tpukube_slice_fragmentation", "tpukube_ingest_nodes_total"):
        assert name in names, name

    with GpuDeviceManager(load_config(env={
            **REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "2,2,1",
            "TPUKUBE_DEVICE_PLUGIN_DIR": str(tmp_path)})) as device, \
            DevicePluginServer(device._config, device) as server:
        journal = EventJournal()
        server.events = journal
        sampler = HealthSampler(device, journal=journal, poll_seconds=999)
        watcher = HealthWatcher(device, server, poll_seconds=999)
        sampler.check_once()
        device.inject_fault(0)
        sampler.check_once()
        watcher.check_once()
        ms = MetricsServer(lambda: render_plugin_metrics(
            server, health=watcher, sampler=sampler, events=journal))
        ms.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics",
                                        timeout=10) as r:
                text = r.read().decode()
        finally:
            ms.stop()
    assert validate_exposition(text) == []
    assert "tpukube_chip_healthy" in {s.name for s in parse_metrics(text)}


# -- config files --------------------------------------------------------------

def _deploy_config_yaml() -> str:
    text = (REPO / "deploy" / "extender-deployment.yaml").read_text()
    block = text.split("config.yaml: |\n", 1)[1]
    lines = []
    for line in block.splitlines():
        if line and not line.startswith("    "):
            break
        lines.append(line[4:])
    return "\n".join(lines) + "\n"


# fields whose defaults differ between the packages (backend, geometry,
# memory, SMs, health probe): compared only where a file sets them
_OWN_DEFAULTS = {"backend", "sim_mesh_dims", "sim_host_block",
                 "hbm_bytes_per_chip", "cores_per_chip", "probe_mode"}

ACCEPTED_FILES = {
    "deploy": _deploy_config_yaml(),
    # the shard router's process transport and its wire codec
    "process-transport": "shard_transport: subprocess\n",
    "wire-codec": "wire_codec: binary\nwire_compress_min_bytes: 256\n",
    "scalars": (
        "# every scalar form a flat file may use\n"
        "---\n"
        "extender_port: 0x3039   # hex\n"
        "events_capacity: 010\n"        # octal: 8
        "health_poll_seconds: 1:30\n"   # base 60: 90
        "reservation_ttl_seconds: 1_5.0_0\n"
        "retry_jitter: .25\n"
        "retry_base_delay_seconds: 2.\n"
        "retry_max_delay_seconds: 1.0e+1\n"
        "snapshot_audit_rate: 0\n"
        "score_mode: 'binpack'\n"
        'slice_id: "nvl\\u002d0"\n'
        "trace_path: /var/run/tpukube/trace.jsonl\n"
        "events_path: ''\n"
        "resource_vtpu: qiniu.com/vtpu#not-a-comment\n"
        "snapshot_delta_enabled: off\n"
        "bulk_ingest_enabled: Yes\n"
        "batch_enabled: on\n"
        "filter_from_plan: TRUE\n"
        "batch_max_pods: +32\n"
        "cycle_interval_seconds: 0.5\n"
        "sim_torus: [true, off, no]\n"
        "sim_mesh_dims: [8, 4, 1]\n"
        "sim_host_block: 8x1x1\n"
        "extender_host: 127.0.0.1\n"
        "shares_per_chip: 2\n"
    ),
    "tuples-as-strings": (
        "sim_mesh_dims: '8,16,1'\n"
        "sim_host_block: 8,1,1\n"
        "sim_torus: 0,1,0\n"
        "backend: sim\n"
    ),
    "duplicate-key": "score_mode: spread\nscore_mode: topology\n",
    "typed-into-other-types": (
        "extender_port: 12345.9\n"      # int(float) truncates
        "trace_path: 1.50\n"            # a float into a string field
        "resource_tpu: yes\n"           # a bool into a string field
        "reservation_ttl_seconds: 30\n"
        "batch_enabled: 1\n"
    ),
    "empty": "# nothing but a comment\n\n",
    "chaos-seed": "chaos_seed: 7\n",
    # refused until the lock-order monitor was ported
    "lock-monitor": "lock_monitor: true\n",
    "sharded-resync": (
        "planner_replicas: 2\n"
        "shard_transport: inprocess\n"
        "generation_log_capacity: 1024\n"
    ),
    "journal": (
        "journal_enabled: true\n"
        "journal_path: /var/lib/tpukube/wal.jsonl\n"
        "checkpoint_interval_seconds: 15\n"
        "journal_fsync: always\n"
    ),
    "tenancy": (
        "tenancy_enabled: true\n"
        "tenancy_quotas: \"team-a=chips:0.5;team-b=chips:1,hbm:0.5\"\n"
        "tenancy_label: tpu.qiniu.com/tenant\n"
        "tenancy_default_tenant: shared\n"
        "tenancy_burn_threshold: 14.4\n"
        "tenancy_burn_window_seconds: 300\n"
        "tenancy_shed_priority_max: 0\n"
    ),
}

REFUSED_FILES = {
    "nested": "score_mode:\n  nested: topology\n",
    "block-list": "sim_mesh_dims:\n- 8\n- 1\n- 1\n",
    "anchor": "score_mode: &a topology\n",
    "alias": "score_mode: *a\n",
    "tag": "score_mode: !!str topology\n",
    "block-scalar": "trace_path: |\n  /tmp/x\n",
    "flow-mapping": "score_mode: {a: 1}\n",
    "two-documents": "score_mode: spread\n---\nscore_mode: topology\n",
    "null": "trace_path: null\n",
    "empty-value": "trace_path:\n",
    "top-level-list": "- score_mode\n",
    "top-level-scalar": "just a string\n",
    "unknown-key": "no_such_field: 1\n",
    "journal-path-without-journal": "journal_path: /var/lib/wal\n",
    "tenancy-quotas-without-tenancy": "tenancy_quotas: a=1\n",
    "bad-int": "extender_port: twelve\n",
    "bad-range": "extender_port: 70000\n",
    "short-tuple": "sim_mesh_dims: [8, 1]\n",
    "timestamp": "trace_path: 2026-10-17\n",
}


def _load_both(tmp_path, text: str):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    out = []
    for load in (load_config, ref_load_config):
        try:
            out.append(load(yaml_path=str(path), env={}))
        except Exception as e:  # the refusal is the result
            out.append(e)
    return out


@pytest.mark.parametrize("name", sorted(ACCEPTED_FILES))
def test_config_file_loads_as_the_reference(tmp_path, name):
    text = ACCEPTED_FILES[name]
    got, want = _load_both(tmp_path, text)
    assert not isinstance(got, Exception), got
    assert not isinstance(want, Exception), want
    port_default = load_config(env={})
    set_keys = set(read_yaml(str(tmp_path / "config.yaml")))
    common = sorted(set(vars(got)) & set(vars(want)))
    assert len(common) > 40
    for f in common:
        if f in _OWN_DEFAULTS and f not in set_keys:
            assert getattr(got, f) == getattr(port_default, f), f
        else:
            assert getattr(got, f) == getattr(want, f), f


# the refused forms the reference refuses too; it reads the others (a block
# list, an anchor, a tag, a block scalar, a null, a timestamp, the key of
# a plane the port lacks with the plane off), which the port's subset
# refuses by design
REFERENCE_REFUSES_TOO = {
    "nested", "alias", "flow-mapping", "two-documents", "top-level-list",
    "top-level-scalar", "unknown-key", "journal-path-without-journal",
    "tenancy-quotas-without-tenancy", "bad-int", "bad-range", "short-tuple",
}
# refusals of the reader itself, which name the file's line
_PARSE_REFUSALS = {
    "nested", "block-list", "anchor", "alias", "tag", "block-scalar",
    "flow-mapping", "two-documents", "null", "empty-value", "top-level-list",
    "top-level-scalar", "timestamp",
}


@pytest.mark.parametrize("name", sorted(REFUSED_FILES))
def test_config_file_forms_outside_the_subset_are_refused(tmp_path, name):
    got, want = _load_both(tmp_path, REFUSED_FILES[name])
    assert isinstance(got, ValueError), got
    if name in _PARSE_REFUSALS:
        assert re.search(r"config\.yaml:\d+: ", str(got)), got
    assert isinstance(want, Exception) is (name in REFERENCE_REFUSES_TOO), want


def test_config_file_then_environment(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("score_mode: binpack\nextender_port: 2000\n")
    for load in (load_config, ref_load_config):
        cfg = load(yaml_path=str(path), env={"TPUKUBE_SCORE_MODE": "spread"})
        assert (cfg.score_mode, cfg.extender_port) == ("spread", 2000)


def test_read_yaml_scalars_resolve_as_safe_load():
    import yaml

    from tpukube_torch.core.config import _y_value

    forms = ["0", "-0", "+1", "010", "08", "0x1F", "0b101", "1_000", "1:30",
             "-1:30", "1.5", "1.", "1.0e3", "1.0e+3", ".5", "-.inf", "yes",
             "No", "ON", "off", "True", "y", "n", "abc", "1e3", "0x", "tpu-0",
             "qiniu.com/tpu", "-5", "v1.2", "0.0.0.0", "'q''x'", '"a\\tb"',
             "x # c", "x#c", "[1, 2, 3]", "[true, off, yes]", "[]"]
    for text in forms:
        want = yaml.safe_load(f"k: {text}")["k"]
        got = _y_value(text, "f:1")
        assert type(got) is type(want) and got == want, text


# -- the daemons as children ---------------------------------------------------

def _child(args: list, **kw) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "tpukube_torch.cli", *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)}, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _wait_healthy(url: str, proc, ctx=None) -> dict:
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        try:
            with urllib.request.urlopen(f"{url}/healthz", timeout=2,
                                        context=ctx) as r:
                return json.loads(r.read())
        except OSError as e:
            last = e
            time.sleep(0.1)
    raise AssertionError(f"daemon never came up: {last}")


def _stop(proc) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_extender_daemon_serves_and_exits_clean():
    # test_cli's test_extender_daemon_subprocess on the port's module, and
    # SIGTERM: exit 0
    from tpukube_torch.sim.harness import _free_port

    port = _free_port()
    proc = _child(["extender", "--host", "127.0.0.1", "--port", str(port),
                   "--kube-api", "off"])
    try:
        assert _wait_healthy(f"http://127.0.0.1:{port}", proc)["ok"] is True
    finally:
        assert _stop(proc) == 0


def test_daemon_trace_replays_clean_on_both_packages(tmp_path):
    """The extender daemon over the stand-in apiserver, from a config
    file: it learns the fleet through its rebuild (bulk ingest) and node
    watch, binds pods through the Binding POST, and releases one through
    the lifecycle loop; SIGTERM exits 0 and its JSONL trace replays with
    no divergence through the port's replay and the reference's."""
    from tpukube_torch.core import codec
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim import SimCluster
    from tpukube_torch.sim.harness import _free_port
    from tpukube_torch.sim.kube_rest import KubeRestServer

    trace_path = tmp_path / "trace.jsonl"
    events_path = tmp_path / "events.jsonl"
    (tmp_path / "config.yaml").write_text(
        "extender_port: 12345\n"
        "score_mode: topology\n"
        "reservation_ttl_seconds: 30.0\n"
        "health_poll_seconds: 0.05\n"
        "backend: sim\n"
        "sim_mesh_dims: [8, 2, 1]\n"
        "sim_host_block: [8, 1, 1]\n"
        f"trace_path: {trace_path}\n"
        f"events_path: {events_path}\n")
    (tmp_path / "token").write_text("kube-token\n")
    cfg = load_config(yaml_path=str(tmp_path / "config.yaml"), env={})
    with SimCluster(cfg, in_process=True) as sim:
        nodes = sim.node_objects()
    port = _free_port()
    with KubeRestServer(token="kube-token") as kube:
        for obj in nodes[:1]:  # one node before the daemon starts
            kube.store.patch_node_annotations(
                obj["metadata"]["name"], obj["metadata"]["annotations"])
        proc = _child(["extender", "--config", str(tmp_path / "config.yaml"),
                       "--host", "127.0.0.1", "--port", str(port),
                       "--kube-api", kube.base_url,
                       "--kube-token-file", str(tmp_path / "token")])
        try:
            url = f"http://127.0.0.1:{port}"
            assert len(_wait_healthy(url, proc)["nodes"]) == 1
            for obj in nodes[1:]:  # the other through the node watch
                kube.store.patch_node_annotations(
                    obj["metadata"]["name"], obj["metadata"]["annotations"])
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            while len(_wait_healthy(url, proc)["nodes"]) < len(nodes):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            names = [n["metadata"]["name"] for n in nodes]
            bound = {}
            for i in range(3):
                pod = pod_object(f"p-{i}", tpu=2)
                kube.store.upsert_pod(pod)
                host, alloc, _ = client.place(port, pod, names)
                bound[f"p-{i}"] = (host, alloc.device_ids)
                stored = kube.store.get_pod("default", f"p-{i}")
                assert stored["spec"]["nodeName"] == host
                assert codec.decode_alloc(stored["metadata"]["annotations"][
                    codec.ANNO_ALLOC]).device_ids == alloc.device_ids
            done = dict(kube.store.get_pod("default", "p-1"))
            done["status"] = {"phase": "Succeeded"}
            kube.store.upsert_pod(done)
            while True:
                with urllib.request.urlopen(f"{url}/state/allocs",
                                            timeout=5) as r:
                    allocs = json.loads(r.read())
                if "default/p-1" not in {a["pod"] for a in allocs}:
                    break
                assert time.monotonic() < deadline
                time.sleep(0.05)
            with urllib.request.urlopen(f"{url}/metrics", timeout=5) as r:
                page = r.read().decode()
            assert f"tpukube_ingest_nodes_total {1}" in page
        finally:
            assert _stop(proc) == 0
    events = trace.load(str(trace_path))
    kinds = [e["kind"] for e in events]
    assert kinds.count("bind") == 3 and kinds.count("release") == 1
    assert "upsert_nodes" in kinds and "upsert_node" in kinds
    assert trace.replay(events, config=cfg) == []
    assert ref_trace.replay(ref_trace.load(str(trace_path)),
                            config=ref_load_config(env=REF_SIM_DEFAULTS)) == []
    # ctl replay on the same capture
    rc = cli.main_ctl(["replay", str(trace_path),
                       "--config", str(tmp_path / "config.yaml")])
    assert rc == 0
    assert events_path.exists()  # the daemon's event sink


def test_cli_loads_no_grpc_yaml_aiohttp_or_torch(tmp_path):
    # importing the CLI, and running sim, ctl, obs and the extender
    # daemon in one process: none of them loads the libraries the GPU
    # machine lacks, nor torch
    code = f"""
import json, os, signal, sys, threading
from tpukube_torch import cli
cli.main_sim(["1"])
cli.main_obs(["events", {str(tmp_path / 'none.jsonl')!r}])
threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
rc = cli.main_extender(["--host", "127.0.0.1", "--port", "0",
                        "--kube-api", "off"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("grpc", "yaml", "aiohttp", "torch")
             or m.startswith("google.protobuf"))
print(json.dumps({{"rc": rc, "loaded": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "loaded": []}


def test_unported_tools_exit_2_naming_their_plane(capsys, tmp_path):
    # shard-worker is ported: it serves /healthz on the port it reports
    write_yaml(str(tmp_path / "w.yaml"), {"planner_replicas": 1})
    worker = subprocess.Popen(
        [sys.executable, "-m", "tpukube_torch.cli", "shard-worker",
         "--config", str(tmp_path / "w.yaml"), "--port", "0"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, text=True)
    try:
        port = json.loads(worker.stdout.readline())["serving"]["port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        worker.terminate()
    assert worker.wait(timeout=10) == 0
    assert cli.main(["nope"]) == 2
    # several captures without --merge are refused, as the reference's
    trace_file = pathlib.Path(tempfile.mkdtemp()) / "t.jsonl"
    trace_file.write_text("")
    with pytest.raises(SystemExit):
        cli.main(["obs", "timeline", str(trace_file), str(trace_file)])


def test_obs_timeline_merge_as_the_reference(tmp_path, capsys):
    # a router capture (a fan-out span with explicit bounds) and a
    # replica capture (a decision tagged with the router's trace
    # context): both packages' tools stitch them into the same trace
    from tpukube.cli import main_obs as ref_main_obs

    router = tmp_path / "trace.jsonl.router"
    replica = tmp_path / "trace.jsonl.r0"
    router.write_text(json.dumps({
        "seq": 1, "ts": 100.5, "kind": "span", "response": None,
        "request": {"name": "route_filter", "pod_key": "default/p",
                    "trace": "t1", "span": "t1.0", "t0": 100.0,
                    "t1": 100.5}}) + "\n")
    replica.write_text(json.dumps({
        "seq": 1, "ts": 100.2, "kind": "filter",
        "ctx": {"trace": "t1", "parent": "t1.0"},
        "request": {"Pod": {"metadata": {"name": "p",
                                         "namespace": "default"}}},
        "response": {"NodeNames": ["n0"]}}) + "\n")
    outs = []
    for main in (cli.main_obs, ref_main_obs):
        assert main(["timeline", "--merge", str(router), str(replica)]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    lanes = [e["args"]["name"] for e in outs[0]["traceEvents"]
             if e["name"] == "process_name"]
    assert lanes == ["trace.jsonl.router", "trace.jsonl.r0"]


@pytest.mark.parametrize("argv", [["obs", "slo", "--snapshot"], ["sim", "7"],
                                  ["obs", "capacity"], ["sim", "15"],
                                  ["obs", "explain", "default/p"],
                                  ["sim", "14"]],
                         ids=["obs-slo", "sim-7", "obs-capacity", "sim-15",
                              "obs-explain", "sim-14"])
def test_tools_once_refused_run_and_exit_0(tmp_path, capsys, monkeypatch,
                                           argv):
    # ``obs slo`` and ``sim 7`` exited 2 while the SLO evaluator was not
    # ported, ``obs capacity`` and ``sim 15`` while capacity analytics and
    # drain were not, ``obs explain`` while decision provenance was not,
    # ``sim 14`` while the shard router was not; they run now (``obs
    # explain`` against a provenance sink capture, ``sim 14`` at the
    # reference's tier-1 smoke size)
    if argv[:2] == ["obs", "explain"]:
        sink = tmp_path / "decisions.jsonl"
        sink.write_text("".join(json.dumps(ev) + "\n" for ev in (
            {"seq": 1, "ts": 1.7e9, "pod": "default/p", "stage": "filter",
             "candidates": 2, "feasible": 1, "pruned": {"full": 1}},
            {"seq": 2, "ts": 1.7e9, "pod": "default/p", "stage": "bind",
             "node": "host-0-0-0", "ok": True, "served_from": "legacy"})))
        argv = [*argv, "--file", str(sink)]
    if argv == ["obs", "capacity"]:
        capture = tmp_path / "capacity.jsonl"
        capture.write_text(json.dumps({"ts": 1.7e9, "fleet": {
            "utilization": 0.5}, "queue": {"depth": 2}}) + "\n")
        argv = [*argv, str(capture)]
    if argv == ["sim", "15"]:
        monkeypatch.setenv("TPUKUBE_MAINT_CYCLES", "2")
    if argv == ["sim", "14"]:
        for k, v in (("TPUKUBE_SHARD_SLICES", "2"),
                     ("TPUKUBE_SIM_MESH_DIMS", "4,4,4"),
                     ("TPUKUBE_PLANNER_REPLICAS", "2"),
                     ("TPUKUBE_KILONODE100K_PODS", "400")):
            monkeypatch.setenv(k, v)
    if argv[:2] == ["obs", "slo"]:
        snap = tmp_path / "metrics.txt"
        snap.write_text('# TYPE gang_schedule_latency_seconds_bucket counter\n'
                        'gang_schedule_latency_seconds_bucket{le="2.5"} 99\n'
                        'gang_schedule_latency_seconds_bucket{le="+Inf"} 100\n')
        argv = [*argv, str(snap)]
    assert cli.main(argv) == 0, argv
    text = capsys.readouterr().out
    if argv[:2] == ["obs", "slo"]:
        assert json.loads(text)["gang-schedule-latency"]["burn_rate"] == 1.0
    elif argv[:2] == ["obs", "capacity"]:
        assert "utilization" in text and "(last 50.0% over 1 samples)" in text
    elif argv[:2] == ["obs", "explain"]:
        assert text.splitlines()[0] == "default/p: PLACED on host-0-0-0"
        assert "1x full" in text
    elif argv[1] == "15":
        out = json.loads(text.strip().splitlines()[-1])
        assert out["scenario"] == 15 and out["storm"]["drains_completed"] >= 1
    elif argv[1] == "14":
        out = json.loads(text.strip().splitlines()[-1])
        assert out["scenario"] == 14 and out["gang_committed"]
        assert len(out["shard"]["replicas"]) == 2
    else:
        out = json.loads(text.strip().splitlines()[-1])
        assert out["scenario"] == 7
        assert out["transitions"] == {"chip_fault": True, "link_fault": True,
                                      "recovery": True}


def test_obs_events_filters_a_capture(tmp_path, capsys):
    from tpukube.cli import main_obs as ref_main_obs

    path = tmp_path / "events.jsonl"
    evs = [
        {"seq": 1, "type": "Normal", "reason": "GangCommitted",
         "object": "gang/default/g", "node": "", "message": "4 members",
         "count": 1, "first_ts": 1_700_000_000.0, "last_ts": 1_700_000_000.0},
        {"seq": 2, "type": "Warning", "reason": "ChipUnhealthy",
         "object": "chip/tpu-1", "node": "host-0-0-0", "message": "xid 79",
         "count": 3, "first_ts": 1_700_000_010.0, "last_ts": 1_700_000_020.0},
    ]
    path.write_text("\n".join(json.dumps(e) for e in evs) + "\n{torn")
    for argv in (["events", str(path)],
                 ["events", str(path), "--reason", "ChipUnhealthy"],
                 ["events", str(path), "--node", "host-0-0-0", "--json"],
                 ["events", str(path), "--since", "15s"]):
        assert cli.main_obs(argv) == 0
        got = capsys.readouterr().out
        assert ref_main_obs(argv) == 0
        assert got == capsys.readouterr().out, argv


# -- chip_smoke's step 14 at a small fleet -------------------------------------

def test_chip_smoke_daemon_step_on_a_small_fleet():
    """chip_smoke.py's step 14 (``daemon_life``) on the CPU: 16 HGX hosts
    and a gang of 8 in place of 1,024 and 256, and this machine's node
    agent on the sim backend (one GPU) with no card pod."""
    import chip_smoke
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet

    @contextlib.contextmanager
    def card_agent():
        cfg = load_config(env={
            "TPUKUBE_BACKEND": "sim", "TPUKUBE_SIM_MESH_DIMS": "1,1,1",
            "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
            "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0"})
        with GpuDeviceManager(cfg, host=chip_smoke.DAEMON_NODE) as mgr, \
                InProcessKubelet() as kubelet:
            server = DevicePluginServer(cfg, mgr)
            kubelet.register_plugin(server)
            kubelet.wait_for_devices(server.resource_name, 1)
            yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)

    got = chip_smoke.daemon_life(card_agent, hosts=16, gang=8)
    assert got["bind"] == [chip_smoke.DAEMON_NODE, ["tpu-0"]]
    assert got["second_bind"] == ["tpu-0"]
    assert got["ingest_nodes_total"] >= 17
    assert got["rebuilt_allocations"] == 9
    assert got["sim5_value"] >= chip_smoke.NORTH_STAR_UTIL
    assert got["replay"].endswith(", 0 divergences")
    for route in ("nodes.list", "nodes.watch", "nodes.patch", "pods.list",
                  "pods.watch", "pods.patch", "pods.binding"):
        assert got["routes"].get(route), route
