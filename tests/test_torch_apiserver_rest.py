"""The port's Kubernetes REST channel held against the reference's.

* Wire parity: the reference's and the port's ``RestApiServer`` send the
  same bytes (method, path and query, headers, body) to one scripted
  apiserver for every surface method, and read its answers the same way.
* The stand-in apiserver (``tpukube_torch.sim.kube_rest``) held to
  ``FakeApiServer``: one op sequence through the port's ``RestApiServer``
  over the stand-in, and straight on a ``FakeApiServer``, leaves equal
  stores and equal watch event sequences.
* ``chip_smoke``'s REST steps (12a-g with the sim backend and no child
  pod, and 12h: config 5 over REST) make the same decisions on both
  packages' loops, each package with its own channel builder (the
  port's ``rest_apiserver_from_config``, the reference CLI's
  ``_make_apiserver``) and its own extender app and ``/metrics`` page.
* The ``/metrics`` series of the loops this channel brings.
"""

import contextlib
import http.server
import json
import os
import tempfile
import threading
import types

import pytest

import chip_smoke
import test_metrics
from tpukube import apiserver as ref_api
from tpukube import cli as ref_cli
from tpukube import metrics as ref_metrics
from tpukube.core import codec as ref_codec
from tpukube.core import retry as ref_retry
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.device import TpuDeviceManager
from tpukube.plugin import DevicePluginServer as RefPluginServer
from tpukube.plugin import FakeKubelet as RefFakeKubelet
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sched.extender import make_app as ref_make_app
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.sim import harness as ref_harness
from tpukube_torch import apiserver, metrics
from tpukube_torch.core import retry
from tpukube_torch.core.config import load_config
from tpukube_torch.device import GpuDeviceManager
from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sched.kube import pod_object
from tpukube_torch.sim.kube_rest import KubeRestServer
from torch_refnative import use_private_tpuinfo
from torch_twin import TMP_PATH, run_twin

use_private_tpuinfo()


def _ref_rest_api(cfg, base_url, token):
    """The reference CLI's channel builder (``_make_apiserver``), with the
    token in a file, as a pod's serviceaccount holds it."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "token")
        with open(path, "w") as f:
            f.write(token)
        return ref_cli._make_apiserver(types.SimpleNamespace(
            kube_api=base_url, kube_token_file=path, kube_ca_file=None), cfg)


def _ref_serve(ext, evictions=None, lifecycle=None, reconcile=None,
               node_refresh=None):
    """The reference's extender app (its own /metrics renderer) on a free
    port, stopped as the port's ``serve`` is."""
    port = ref_harness._free_port()
    app = ref_harness._AppThread(ref_make_app(
        ext, reconcile=reconcile, evictions=evictions, node_refresh=node_refresh,
        lifecycle=lifecycle), "127.0.0.1", port)
    app.start()
    return types.SimpleNamespace(server_address=("127.0.0.1", port),
                                 shutdown=app.stop, server_close=lambda: None)


REF = types.SimpleNamespace(
    api=ref_api, metrics=ref_metrics, codec=ref_codec, load_config=ref_load_config,
    PodGroup=RefPodGroup, Extender=RefExtender, SimCluster=RefSimCluster,
    sim_kw={"in_process": True}, retry=ref_retry, serve=_ref_serve,
    rest_api=_ref_rest_api)
PORT = types.SimpleNamespace(**vars(chip_smoke.port_pkg()), retry=retry)


# -- wire parity ---------------------------------------------------------------

def _pod(name, node=""):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"nodeName": node} if node else {}}


def _events(*objs):
    return [json.dumps({"type": t, "object": o}).encode() + b"\n" for t, o in objs]


PAGES = [
    {"items": [_pod("p0")], "metadata": {"continue": "tok 1"}},
    {"items": [_pod("p1")], "metadata": {"continue": "tok2"}},
    {"items": [_pod("p2")], "metadata": {"resourceVersion": "9001"}},
]
NODE = {"metadata": {"name": "n1", "annotations": {"a": "b"}}}
# the scripted apiserver's answers, one per request, in order
SCRIPT = (
    [(200, {}), (200, NODE), (200, {})]
    + [(200, p) for p in PAGES] * 2
    + [(200, {"items": [NODE], "metadata": {"resourceVersion": "7"}})] * 2
    + [(200, _events(("ADDED", _pod("p0")), ("MODIFIED", _pod("p1")),
                     ("DELETED", _pod("p2"))) + [b"{not json\n"]),
       (200, _events(("MODIFIED", NODE))),
       (404, {"code": 404})]
    # bind: precheck GET, annotation PATCH, Binding POST
    + [(200, _pod("p0")), (200, {}), (201, {})]
    # bind to a pod bound elsewhere: the precheck GET answers, nothing else
    + [(200, _pod("p0", "host-b"))]
    # a Binding that raced in: GET, POST 409, the verifying GET
    + [(200, _pod("p0")), (409, {}), (200, _pod("p0", "host-a"))]
    # evictions: accepted, PDB-blocked, gone, dry run, server error
    + [(201, {}), (429, {}), (404, {}), (201, {}), (500, {})]
    + [(200, {}), (404, {})]  # deletes
    # through a Retrier and a CircuitBreaker: a 503 retried; then two
    # 503s open the circuit, and the third attempt fails fast
    + [(503, {}), (200, _pod("p0")), (503, {}), (503, {})]
)


class _Scripted(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _any(self):
        rec = self.server.rec
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        rec.seen.append((self.command, self.path,
                         sorted((k, v) for k, v in self.headers.items()), body))
        status, payload = SCRIPT[len(rec.seen) - 1]
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if isinstance(payload, list):  # a watch: chunked JSON lines
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for line in payload:
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            self.close_connection = True
            return
        raw = json.dumps(payload).encode()
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    do_GET = do_PATCH = do_POST = do_DELETE = _any

    def log_message(self, *a):
        pass


@contextlib.contextmanager
def _scripted():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    httpd.rec = types.SimpleNamespace(seen=[])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()


def _surface(pkg, base_url) -> list:
    """Every RestApiServer surface method, in SCRIPT's order; each call's
    outcome (its value, or the error's HTTP code)."""
    api = pkg.api.RestApiServer(base_url=base_url, token="sekrit")
    out = []

    def call(name, fn, *args, **kw):
        try:
            got = fn(*args, **kw)
            out.append((name, list(got) if name.startswith("watch") else got))
        except pkg.api.ApiServerError as e:
            out.append((name, "ApiServerError", e.code))

    call("patch_node", api.patch_node_annotations, "n1", {"a": "b"})
    call("get_node", api.get_node_annotations, "n1")
    call("patch_pod", api.patch_pod_annotations, "default", "p0", {"x": None, "y": "z"})
    call("list_pods", api.list_pods, "n1")
    call("list_pods_rv", api.list_pods_with_rv)
    call("list_nodes_rv", api.list_nodes_with_rv)
    call("list_nodes", api.list_nodes)
    call("watch_pods", api.watch_pods, "n1", timeout_seconds=30, resource_version="4 2")
    call("watch_nodes", api.watch_nodes, timeout_seconds=30, resource_version="7")
    call("get_missing", api.get_pod, "default", "gone")
    call("bind", api.bind_pod, "default", "p0", "host-a", {"k": "v"})
    call("bind_elsewhere", api.bind_pod, "default", "p0", "host-a", {"k": "v"})
    call("bind_raced", api.bind_pod, "default", "p0", "host-a")
    for _ in range(3):
        call("evict", api.evict_pod, "default", "p0")
    call("evict_dry", api.evict_pod, "default", "p0", dry_run=True)
    call("evict_500", api.evict_pod, "default", "p0")
    call("delete", api.delete_pod, "default", "p1")
    call("delete_gone", api.delete_pod, "default", "gone")
    r = pkg.retry
    circuit = r.CircuitBreaker(failure_threshold=2, reset_seconds=30.0,
                               name="apiserver")
    guarded = pkg.api.RestApiServer(
        base_url=base_url, token="sekrit", circuit=circuit,
        retrier=r.Retrier(r.RetryPolicy(max_attempts=3, base_delay=0.001,
                                        jitter=0.0, deadline=0),
                          name="apiserver", retryable=pkg.api.transient_api_error))
    call("get_retried", guarded.get_pod, "default", "p0")
    call("get_circuit", guarded.get_pod, "default", "p0")
    out.append(("circuit", circuit.state(), circuit.opens))
    return out


def test_rest_client_sends_the_reference_bytes():
    runs = {}
    for pkg in (REF, PORT):
        with _scripted() as httpd:
            result = _surface(pkg, f"http://127.0.0.1:{httpd.server_address[1]}")
            port = httpd.server_address[1]
            runs[pkg is PORT] = (result, [
                (m, p, [(k, v.replace(str(port), "PORT")) for k, v in h], b)
                for m, p, h, b in httpd.rec.seen])
    (ref_out, ref_wire), (port_out, port_wire) = runs[False], runs[True]
    assert port_wire == ref_wire
    assert port_out == ref_out
    assert len(ref_wire) == len(SCRIPT)
    paths = [p for _, p, _, _ in ref_wire]
    assert paths[4] == "/api/v1/pods?limit=500&fieldSelector=spec.nodeName%3Dn1" \
        "&continue=tok%201"
    assert paths[11] == ("/api/v1/pods?watch=1&timeoutSeconds=30&fieldSelector="
                         "spec.nodeName%3Dn1&resourceVersion=4%202")
    got = dict((e[0], e[1:]) for e in port_out)
    assert [t for t, _ in got["watch_pods"][0]] == ["ADDED", "MODIFIED", "DELETED"]
    assert got["get_missing"] == (None,)
    assert got["bind_elsewhere"] == ("ApiServerError", 409)
    assert [e[1] for e in port_out if e[0] == "evict"] == [True, False, True]
    assert got["evict_500"] == ("ApiServerError", 500)
    assert got["get_circuit"] == ("ApiServerError", None)
    assert got["circuit"] == ("open", 1)
    assert ("Authorization", "Bearer sekrit") in ref_wire[0][2]


# -- the stand-in held to FakeApiServer -----------------------------------------

def _ops(api, store) -> list:
    """One op sequence over ``api`` (``store`` plays kubectl and the
    kubelet: it creates pods and finishes terminations)."""
    out = []

    def call(fn, *args, **kw):
        try:
            out.append(fn(*args, **kw))
        except apiserver.ApiServerError as e:
            out.append(("ApiServerError", e.code))

    for n in ("n0", "n1", "n2"):
        call(api.patch_node_annotations, n, {"topology": n})
    call(api.patch_node_annotations, "n1", {"health": "1 down"})
    for i in range(6):
        store.upsert_pod(pod_object(f"p{i}", tpu=1))
    store.graceful.add("default/p3")
    store.pdb_blocked.add("default/p4")
    call(api.bind_pod, "default", "p0", "n0")
    call(api.bind_pod, "default", "p1", "n1")
    call(api.bind_pod, "default", "p5", "n1")
    call(api.patch_pod_annotations, "default", "p0", {"a": "1", "b": "2"})
    call(api.patch_pod_annotations, "default", "p0", {"a": None})
    call(api.bind_pod, "default", "p0", "n2")      # bound elsewhere: 409
    call(api.bind_pod, "default", "nope", "n2")    # no such pod: 404
    call(api.get_pod, "default", "nope")
    call(api.evict_pod, "default", "p4", dry_run=True)  # PDB: refused
    call(api.evict_pod, "default", "p2")
    call(api.evict_pod, "default", "p3")           # graceful: lingers
    call(api.evict_pod, "default", "p4")
    call(api.get_pod, "default", "p3")
    store.finish_termination("default", "p3")
    call(api.delete_pod, "default", "p1")
    call(api.delete_pod, "default", "p1")          # already gone
    call(api.get_node_annotations, "n1")
    call(api.get_pod, "default", "p0")
    call(lambda: sorted(p["metadata"]["name"] for p in api.list_pods()))
    call(lambda: sorted(p["metadata"]["name"] for p in api.list_pods("n1")))
    call(api.list_nodes)
    call(lambda: api.list_pods_with_rv()[1])
    call(lambda: api.list_nodes_with_rv()[1])
    return out


def _replay(api) -> tuple:
    """Every pod and node event since the stores began, as each watch
    replays them from resourceVersion 0."""
    return (list(api.watch_pods(timeout_seconds=1, resource_version="0")),
            list(api.watch_nodes(timeout_seconds=1, resource_version="0")))


def test_stand_in_is_the_fake_apiserver_over_http():
    fake = apiserver.FakeApiServer()
    want = _ops(fake, fake)
    want_events = _replay(fake)
    with KubeRestServer(token="t") as kube:
        api = apiserver.RestApiServer(base_url=kube.base_url, token="t")
        api.LIST_PAGE_LIMIT = 2  # every list pages
        got = _ops(api, kube.store)
        got_events = _replay(api)
        counts = dict(kube.requests)
    assert got == want
    assert kube.store._pods == fake._pods
    assert kube.store._nodes == fake._nodes
    assert got_events == want_events
    assert [t for t, _ in got_events[0]].count("DELETED") == 3
    # three pod lists of 3, 1 and 3 pods, in pages of 2; four Binding
    # POSTs (the bind to a pod bound elsewhere stops at its GET)
    assert counts["pods.list"] == 5 and counts["pods.binding"] == 4
    assert counts["pods.eviction"] == 4 and "unauthorized" not in counts


def test_annotated_bind_over_rest_patches_before_it_binds():
    # the REST bind is two writes (the alloc annotation while the pod is
    # still Pending, then the Binding), where the fake's bind_pod is one:
    # the stores end equal, the stand-in's stream shows both steps
    fake = apiserver.FakeApiServer()
    fake.upsert_pod(pod_object("p0", tpu=1))
    fake.bind_pod("default", "p0", "n0", {"k": "v"})
    with KubeRestServer() as kube:
        kube.store.upsert_pod(pod_object("p0", tpu=1))
        apiserver.RestApiServer(base_url=kube.base_url).bind_pod(
            "default", "p0", "n0", {"k": "v"})
        events = list(kube.store.watch_pods(timeout_seconds=0.2,
                                            resource_version="0"))
    assert kube.store._pods == fake._pods
    steps = [(t, p["spec"].get("nodeName"), p["metadata"]["annotations"].get("k"))
             for t, p in events]
    assert steps == [("ADDED", None, None), ("MODIFIED", None, "v"),
                     ("MODIFIED", "n0", "v")]


def test_stand_in_refuses_what_an_apiserver_refuses():
    with KubeRestServer(token="t") as kube:
        for i in range(5):
            kube.store.upsert_pod(pod_object(f"p{i}", tpu=1))
        api = apiserver.RestApiServer(base_url=kube.base_url, token="t")
        with pytest.raises(apiserver.ApiServerError) as e:
            apiserver.RestApiServer(base_url=kube.base_url, token="x").list_pods()
        assert e.value.code == 401
        with pytest.raises(apiserver.ApiServerError) as e:
            api._request("GET", "/api/v1/pods?limit=2&continue=s99:2")
        assert e.value.code == 410  # an expired continue token
        with pytest.raises(apiserver.ApiServerError) as e:
            api._request("GET", "/api/v1/configmaps")
        assert e.value.code == 404
        with pytest.raises(apiserver.ApiServerError) as e:
            api._request("GET", "/api/v1/pods?fieldSelector=status.phase%3DRunning")
        assert e.value.code == 400
        kube.store._history.popleft()
        with pytest.raises(apiserver.ApiServerError) as e:
            list(api.watch_pods(resource_version="0", timeout_seconds=1))
        assert e.value.code == 410  # older than the store's history
        first = api._request("GET", "/api/v1/pods?limit=2")
        assert first["metadata"]["continue"] and len(first["items"]) == 2
        assert kube.requests["unauthorized"] == 1


# -- chip_smoke's REST steps, both packages -------------------------------------

@pytest.fixture(scope="module")
def fleets():
    return chip_smoke.rest_fleet(PORT), chip_smoke.rest_fleet(REF)


def test_config5_over_rest_decides_as_the_reference(fleets):
    port, ref = fleets
    for key in ("burst", "gang", "util_burst", "utilization", "util_after_release",
                "committed", "victims", "evicted", "binding_posts", "bound",
                "preemptions", "released", "refreshed", "listed", "hosts"):
        assert port[key] == ref[key], key
    # the contract chip_smoke holds the card's run to
    coords = {c for _, _, cs in port["gang"] for c in cs}
    nodes = sorted({n for n, _, _ in port["gang"]})
    ys = sorted({c[1] for c in coords})
    assert len(coords) == 64 and len(nodes) == 8
    assert all(set(port["hosts"][n]) <= coords for n in nodes)
    assert ys == list(range(ys[0], ys[0] + 8))
    assert port["evicted"] == port["victims"] and len(port["victims"]) == 16
    assert port["binding_posts"] == 144 == len(port["binding_post_ms"])
    assert port["released"] == 64 and port["util_after_release"] == 0.5
    assert port["listed"] and port["routes"]["pods.eviction"] == 32  # + dry runs
    series = ("tpukube_node_refreshes_total", "tpukube_lifecycle_releases_total",
              "tpukube_evictions_total", "tpukube_binds_total",
              "tpukube_preemptions_total", "tpu_chip_utilization_percent",
              "tpukube_reconciles_total")
    pm = chip_smoke.metric_lines(port["metrics"])
    rm = chip_smoke.metric_lines(ref["metrics"])
    assert {k: pm[k] for k in series} == {k: rm[k] for k in series}
    assert pm["tpukube_node_refreshes_total"] == 16


@contextlib.contextmanager
def _port_agent(env, host):
    cfg = load_config(env={"TPUKUBE_BACKEND": "sim", **env})
    with GpuDeviceManager(cfg, host=host) as mgr, InProcessKubelet() as kubelet:
        server = DevicePluginServer(cfg, mgr)
        kubelet.register_plugin(server)
        kubelet.wait_for_devices(server.resource_name, len(mgr.device_list()))
        yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)


@contextlib.contextmanager
def _ref_agent(env, host):
    with tempfile.TemporaryDirectory() as td:
        cfg = ref_load_config(env={"TPUKUBE_BACKEND": "sim",
                                   "TPUKUBE_DEVICE_PLUGIN_DIR": td, **env})
        with TpuDeviceManager(cfg, host=host) as mgr, \
                RefPluginServer(cfg, mgr) as server, RefFakeKubelet(td) as kubelet:
            server.register_with_kubelet()
            kubelet.wait_for_devices(server.resource_name, len(mgr.device_list()))
            yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)


CARD_NODE_ENV = {"TPUKUBE_SIM_MESH_DIMS": "1,1,1", "TPUKUBE_SIM_HOST_BLOCK": "1,1,1"}


def _pod_check(env: dict) -> dict:
    """What the card's ``--scheduled`` pod checks before it serves: its
    Allocate env against the alloc annotation it was bound with."""
    from tpukube_torch import graft
    from tpukube_torch.workload.meshenv import PodGpuEnv

    return graft.check_scheduled_env(PodGpuEnv.from_env(env), env[graft.ENV_ALLOC])


def test_card_step_host_sequence_decides_as_the_reference():
    # chip_smoke's steps 12a-g on the sim backend; in place of the card's
    # child pod, the check it runs on its env (the port's run)
    got = chip_smoke.rest_pod_life(
        PORT, lambda: _port_agent(CARD_NODE_ENV, "host-0-0-0"),
        lambda: _port_agent(chip_smoke.SHARE_NODE_ENV, "share-node"),
        run_child=_pod_check)
    want = chip_smoke.rest_pod_life(
        REF, lambda: _ref_agent(CARD_NODE_ENV, "host-0-0-0"),
        lambda: _ref_agent(chip_smoke.SHARE_NODE_ENV, "share-node"))
    for key in ("bind", "preferred", "second_bind", "released", "divergence",
                "metrics", "intent_watch_events", "routes"):
        assert got[key] == want[key], key
    assert got["bind"] == ["host-0-0-0", ["tpu-0"]]
    assert got["child"]["pod"] == "default/rest-0"
    assert got["child"]["device_ids"] == ["tpu-0"] and got["child"]["gang"] == ["1", "", "0"]
    assert got["divergence"] == {
        "planned": ["tpu-0-frac0of2"], "kubelet": ["tpu-0-frac1of2"],
        "ledger": ["tpu-0-frac1of2"], "annotation": ["tpu-0-frac1of2"],
        "reconciled": 1, "divergences": 1}
    assert got["metrics"] == {
        "tpukube_reconciles_total": 1.0, "tpukube_node_refreshes_total": 2.0,
        "tpukube_lifecycle_releases_total": 1.0, "tpukube_binds_total": 3.0,
        # every unary request once (the routes less the streams), none retried
        'tpukube_retry_attempts_total{op="apiserver"}': 21.0,
        'tpukube_retry_retries_total{op="apiserver"}': 0.0,
        'tpukube_circuit_state{circuit="apiserver"}': 0.0}
    # rest-0's Binding, Succeeded and DELETED, then rest-1's Binding
    assert got["intent_watch_events"] == 4
    # every route but the Eviction subresource (config 5's) is used here
    assert set(chip_smoke.REST_ROUTES) - set(got["routes"]) == {"pods.eviction"}
    for key in ("file_to_topology_ms", "bind_to_intent_ms", "phase_to_release_ms"):
        assert 0 < got[key] < chip_smoke.REST_WAIT_S * 1e3


def test_batch_card_step_decides_as_the_reference():
    # chip_smoke's step 13d on the sim backend: a pending pod admitted by
    # the informer's PodAdmissionFeed, planned, answered from the plan and
    # bound over REST; in place of the card's child pod, the check it runs
    # on its env (the port's run)
    got = chip_smoke.batch_pod_life(
        PORT, lambda: _port_agent(CARD_NODE_ENV, "host-0-0-0"),
        run_child=_pod_check)
    want = chip_smoke.batch_pod_life(
        REF, lambda: _ref_agent(CARD_NODE_ENV, "host-0-0-0"))
    for key in ("planned", "planned_node", "bind", "preferred", "metrics",
                "admitted", "released", "routes"):
        assert got[key] == want[key], key
    assert got["bind"] == ["host-0-0-0", ["tpu-0"]]
    assert got["child"]["pod"] == "default/batch-0"
    assert got["child"]["device_ids"] == ["tpu-0"]
    # filter and bind answered from the plan; prioritize asks for scores
    # a driver-planned pod was not given, so the per-pod path answers it
    assert got["metrics"] == {
        "tpukube_cycles_total": 1.0, "tpukube_cycle_pods_planned_total": 1.0,
        "tpukube_cycle_plan_hits_total": 2.0,
        "tpukube_cycle_plan_misses_total": 1.0,
        "tpukube_cycle_assumes_total": 1.0, "tpukube_binds_total": 1.0,
        "tpukube_lifecycle_releases_total": 1.0}
    for key in ("added_to_admitted_ms", "admitted_to_planned_ms",
                "bind_to_intent_ms"):
        assert 0 < got[key] < chip_smoke.REST_WAIT_S * 1e3


# -- /metrics of the loops ------------------------------------------------------

@pytest.mark.parametrize("name", ["test_syncer_metrics_render",
                                  "test_plugin_metrics_export_intent_watch"])
def test_reference_metrics_tests_hold_on_the_port(name):
    run_twin(vars(test_metrics)[name], TMP_PATH)


def _loop_page(pkg) -> dict:
    """test_metrics' reconcile/node-refresh/lifecycle exports, and the
    retry/circuit section of an extender with the channel's Retrier and
    CircuitBreaker attached, rendered by ``pkg`` (the reference serves the
    same registry through its aiohttp app)."""
    ext = pkg.Extender(pkg.load_config(env={
        "TPUKUBE_SIM_MESH_DIMS": "2,2,1", "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"}))
    api = pkg.api.FakeApiServer()
    reconcile = pkg.api.AllocReconcileLoop(ext, api, poll_seconds=999)
    evictions = pkg.api.EvictionExecutor(ext, api, poll_seconds=999)
    refresh = pkg.api.NodeTopologyRefreshLoop(ext, api, poll_seconds=999)
    lifecycle = pkg.api.PodLifecycleReleaseLoop(ext, api, poll_seconds=999,
                                                use_watch=False, evictions=evictions)
    reconcile.reconciled, refresh.refreshed, lifecycle.released = 5, 3, 9
    ext.api_retrier = pkg.retry.Retrier(pkg.retry.RetryPolicy(), name="apiserver")
    ext.api_circuit = pkg.retry.CircuitBreaker(1, 30.0, name="apiserver")
    ext.api_circuit.on_failure()
    text = pkg.metrics.render_extender_metrics(
        ext, reconcile=reconcile, evictions=evictions, node_refresh=refresh,
        lifecycle=lifecycle)
    return chip_smoke.metric_lines(text), [
        line for line in text.splitlines() if line.startswith("#")]


def test_loop_series_render_as_the_reference():
    got, got_meta = _loop_page(PORT)
    want, want_meta = _loop_page(REF)
    for key in ("tpukube_reconciles_total", "tpukube_node_refreshes_total",
                "tpukube_lifecycle_releases_total",
                'tpukube_circuit_state{circuit="apiserver"}',
                'tpukube_circuit_opens_total{circuit="apiserver"}',
                'tpukube_retry_attempts_total{op="apiserver"}'):
        assert got[key] == want[key], key
    assert (got["tpukube_reconciles_total"], got["tpukube_node_refreshes_total"],
            got['tpukube_circuit_state{circuit="apiserver"}']) == (5, 3, 2)
    circuit_meta = [m for m in want_meta if "tpukube_circuit" in m]
    assert circuit_meta and all(m in got_meta for m in circuit_meta)


# -- the channel built from the config ---------------------------------------

@pytest.mark.parametrize("env", [{}, {
    "TPUKUBE_RETRY_MAX_ATTEMPTS": "3", "TPUKUBE_RETRY_ATTEMPT_TIMEOUT_SECONDS": "2.5",
    "TPUKUBE_CIRCUIT_FAILURE_THRESHOLD": "4", "TPUKUBE_CIRCUIT_RESET_SECONDS": "7.5",
    "TPUKUBE_CIRCUIT_HALF_OPEN_PROBES": "2"}])
def test_channel_from_config_is_built_as_the_reference_cli_builds_it(env):
    def built(pkg) -> tuple:
        api = pkg.rest_api(pkg.load_config(env=env), "http://127.0.0.1:1", "t")
        r, c = api.retrier, api.circuit
        return (api._base, api._token, api._timeout, r.name, vars(r.policy),
                r._retryable(pkg.api.ApiServerError("x", 503)),
                r._retryable(pkg.api.ApiServerError("x", 409)),
                c.name, c.failure_threshold, c.reset_seconds, c.half_open_probes,
                c.enabled)

    assert built(PORT) == built(REF)
