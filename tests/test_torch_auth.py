"""The port extender's HTTP surface held against the reference's: bearer
auth, mTLS, the probe listener, and the bodies of every route; and the
port's daemons as users start them (``python -m tpukube_torch.cli
extender|plugin``).

- test_auth.py's five tests run on both packages (``run_twin``): the
  port's ``make_app``/``make_probe_app`` served by its harness's
  ``_AppThread`` (``http.server``), the reference's by aiohttp;
- the same requests go to the reference's app and the port's, each over
  an extender that made the same decisions: status codes and JSON bodies
  must be equal (timestamps and host timings aside);
- the extender daemon with ``--tls-cert/--tls-key/--tls-client-ca`` and
  ``--probe-port``, with the PKI of test_auth.py: a client without a
  certificate fails its own handshake and the daemon keeps serving, a
  client that stalls in its handshake blocks no other, ``ctl`` speaks
  mTLS, and SIGTERM exits 0 with no traceback;
- test_plugin_daemon.py's lifecycle on ``python -m tpukube_torch.cli
  plugin`` (the env under the port's CUDA names), with its /statusz."""

import contextlib
import io
import json
import os
import pathlib
import re
import signal
import socket
import ssl
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

import pytest

import test_auth
from tpukube.core.config import load_config as ref_load_config
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sched.extender import make_app as ref_make_app
from tpukube.sim import SimCluster as RefSim
from tpukube.sim.harness import _AppThread as RefAppThread
from tpukube_torch import cli
from tpukube_torch.core.config import load_config
from tpukube_torch.sched.extender import Extender, make_app
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim.harness import _AppThread, _free_port
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, reference_tests, run_twin

use_private_tpuinfo()

REPO = pathlib.Path(__file__).resolve().parent.parent
CHILD_TIMEOUT_S = 20.0


@pytest.fixture(scope="module")
def tls_pki(tmp_path_factory):
    # test_auth.py's CA, server certificate (SAN 127.0.0.1) and client
    # certificate
    return test_auth.tls_pki._get_wrapped_function()(tmp_path_factory)


@pytest.mark.parametrize("fn", reference_tests(test_auth, {}),
                         ids=lambda f: f.__name__)
def test_reference_auth_tests_hold_on_the_port(fn, tls_pki):
    run_twin(fn, {"tls_pki": lambda g: contextlib.nullcontext(tls_pki)})


# -- the same requests to both apps ---------------------------------------------

TOKEN = "s3cret"
_VOLATILE = {"ts", "time", "first_ts", "last_ts", "sink_path", "latency_s"}


def _scrub(doc):
    """The body less what differs by host time, not by decision (an
    event message's "in 0.011s" included)."""
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    if isinstance(doc, str):
        return re.sub(r" in \d+\.\d+s\b", " in <host time>", doc)
    return doc


def _request(base: str, method: str, path: str, body=None, token=TOKEN,
             header=None):
    req = urllib.request.Request(
        f"{base}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    if header is not None:
        req.add_header("Authorization", header)
    elif token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    if ctype.startswith("application/json"):
        return status, _scrub(json.loads(raw))
    return status, None


def _text(base: str, path: str, token=TOKEN) -> tuple[int, str]:
    """(status, body text) of a GET, for routes that answer text/plain."""
    req = urllib.request.Request(f"{base}{path}")
    req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@contextlib.contextmanager
def _both_apps(extra: Optional[dict] = None):
    """The reference's app and the port's, each over a sim fleet of 8 GPUs
    per host (8,2,1) and an extender of the same config (``extra`` on top),
    behind the same bearer token. Yields (port base URL, reference base
    URL, nodes)."""
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "8,2,1",
           "TPUKUBE_SIM_HOST_BLOCK": "8,1,1", **(extra or {})}
    with RefSim(ref_load_config(env=env), in_process=True) as sim:
        nodes = sim.node_objects()
    port_ext = Extender(load_config(env=env))
    ref_ext = RefExtender(ref_load_config(env=env))
    ports = (_free_port(), _free_port())
    apps = (_AppThread(make_app(port_ext, auth_token=TOKEN), "127.0.0.1", ports[0]),
            RefAppThread(ref_make_app(ref_ext, auth_token=TOKEN), "127.0.0.1",
                         ports[1]))
    for app in apps:
        app.start()
    try:
        yield tuple(f"http://127.0.0.1:{p}" for p in ports) + (nodes,)
    finally:
        for app in apps:
            app.stop()
        for ext in (port_ext, ref_ext):
            ext.trace.close()
            ext.events.close()
            if ext.decisions is not None:
                ext.decisions.close()


def test_every_route_answers_as_the_reference():
    from tpukube_torch.core import codec
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.sched.kube import pod_object

    group = codec.pod_group_annotations(PodGroup("g", min_member=2))
    pods = [pod_object("a", tpu=2), pod_object("g-0", tpu=4, annotations=group),
            pod_object("g-1", tpu=4, annotations=group), pod_object("big", tpu=16)]
    with _both_apps() as (port_url, ref_url, nodes):
        names = [n["metadata"]["name"] for n in nodes]
        compared = 0

        def same(method, path, body=None, **kw):
            nonlocal compared
            got = _request(port_url, method, path, body, **kw)
            want = _request(ref_url, method, path, body, **kw)
            assert got == want, (method, path)
            compared += 1
            return got

        for pod in pods:
            meta = pod["metadata"]
            status, fres = same("POST", "/filter",
                                {"Pod": pod, "Nodes": {"Items": nodes}})
            assert status == 200
            if not fres["NodeNames"]:
                continue
            same("POST", "/prioritize", {"Pod": pod, "NodeNames": names})
            same("POST", "/bind", {"PodName": meta["name"],
                                   "PodNamespace": "default",
                                   "PodUID": meta["uid"],
                                   "Node": fres["NodeNames"][0]})
        for path in ("/healthz", "/state/topology", "/state/allocs",
                     "/state/gangs", "/trace", "/trace?since=3",
                     "/events", "/events?reason=GangCommitted",
                     "/events?pod=default/g-0", "/events?node=host-0-0-0",
                     "/events?since=1e12", "/trace?since=x", "/events?since=x",
                     "/no-such-route", "/metrics"):
            same("GET", path)
        # the auth gate: missing, wrong and non-ASCII tokens, and the
        # open probe routes
        for path in ("/state/allocs", "/trace", "/statusz", "/no-such-route"):
            for kw in ({"token": None}, {"token": "wrong"},
                       {"header": "Bearer tüken"}):
                assert same("GET", path, **kw)[0] == 401
        for path in ("/healthz", "/metrics"):
            assert same("GET", path, token=None)[0] == 200
        assert same("POST", "/bind", {}, token=None)[0] == 401
        # /statusz: every section of a ported plane, as the reference's
        got = _request(port_url, "GET", "/statusz")[1]
        want = _request(ref_url, "GET", "/statusz")[1]
        for key in ("component", "ledger", "gangs", "pending_evictions",
                    "pod_watch", "node_watch", "fleet", "cycle", "journal",
                    "tenants", "decisions"):
            assert got[key] == want[key], key
        for key in ("capacity", "lifecycle_releases", "reconciles"):
            assert key not in got and key not in want
        for key in ("enabled", "capacity", "events", "last_seq", "dropped",
                    "sink_bytes", "sink_rotations"):
            assert got["trace"][key] == want["trace"][key], key
        assert got["events"]["by_reason"] == want["events"]["by_reason"]
        assert got["events"]["recent"] == want["events"]["recent"]
        keep = ("rebuilds", "hits", "audit", "delta", "slices")
        assert ({k: got["snapshot"][k] for k in keep}
                == {k: want["snapshot"][k] for k in keep})
        assert got["ingest"]["nodes_total"] == want["ingest"]["nodes_total"]
        # /explain and /capacity with their planes off: 404 on both, with
        # the reference's text
        for path in ("/explain?pod=default/a", "/capacity",
                     "/capacity/probe?count=4"):
            assert same("GET", path)[0] == 404
            assert _text(port_url, path) == _text(ref_url, path)
        assert "decisions_enabled" in _text(port_url, "/explain?pod=a")[1]
        assert compared > 40


def test_explain_answers_as_the_reference_with_the_plane_on():
    """/explain with decision provenance on: the same webhooks to both
    apps, then each pod's explain document is the reference's (less the
    host times ``ts`` of each stage), behind the same bearer gate; a
    missing pod parameter is the reference's 400, and /statusz's
    ``decisions`` section matches but for its host-time fields."""
    from tpukube_torch.sched.kube import pod_object

    pods = [pod_object("a", tpu=2), pod_object("b", tpu=4),
            pod_object("big", tpu=64)]
    on = {"TPUKUBE_DECISIONS_ENABLED": "1"}
    with _both_apps(on) as (port_url, ref_url, nodes):
        names = [n["metadata"]["name"] for n in nodes]
        for pod in pods:
            meta = pod["metadata"]
            fres = [_request(u, "POST", "/filter",
                             {"Pod": pod, "Nodes": {"Items": nodes}})
                    for u in (port_url, ref_url)]
            assert fres[0] == fres[1]
            if not fres[0][1]["NodeNames"]:
                continue
            for u in (port_url, ref_url):
                _request(u, "POST", "/prioritize",
                         {"Pod": pod, "NodeNames": names})
                _request(u, "POST", "/bind", {
                    "PodName": meta["name"], "PodNamespace": "default",
                    "PodUID": meta["uid"],
                    "Node": fres[0][1]["NodeNames"][0]})
        verdicts = {}
        for path in ("/explain?pod=default/a", "/explain?pod=b",
                     "/explain?pod=big", "/explain?pod=default/ghost"):
            got = _request(port_url, "GET", path)
            assert got == _request(ref_url, "GET", path), path
            assert got[0] == 200
            verdicts[got[1]["pod"]] = got[1]["verdict"]
        assert verdicts == {"default/a": "placed", "default/b": "placed",
                            "default/big": "pending",
                            "default/ghost": "unknown"}
        assert _text(port_url, "/explain") == _text(ref_url, "/explain")
        assert _text(port_url, "/explain")[0] == 400
        for kw in ({"token": None}, {"token": "wrong"}):
            assert _request(port_url, "GET", "/explain?pod=a", **kw)[0] \
                == _request(ref_url, "GET", "/explain?pod=a", **kw)[0] == 401
        host = ("record_seconds",)
        got = _request(port_url, "GET", "/statusz")[1]["decisions"]
        want = _request(ref_url, "GET", "/statusz")[1]["decisions"]
        assert ({k: v for k, v in got.items() if k not in host}
                == {k: v for k, v in want.items() if k not in host})
        assert got["enabled"] is True and got["recorded"] > 0


# -- the extender daemon over mTLS --------------------------------------------

def _child(args: list, env=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "tpukube_torch.cli", *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _stop(proc) -> tuple[int, str]:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    return rc, proc.stderr.read()


def _wait_for(cond, proc, what: str):
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        with contextlib.suppress(OSError):
            got = cond()
            if got:
                return got
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def _get(url: str, ctx=None):
    with urllib.request.urlopen(url, timeout=5, context=ctx) as r:
        return r.status, r.read()


def test_extender_daemon_serves_mtls_and_the_probe_port(tls_pki, tmp_path):
    d = tls_pki
    (tmp_path / "config.yaml").write_text(
        "backend: sim\nsim_mesh_dims: [8, 2, 1]\nsim_host_block: [8, 1, 1]\n")
    port, probe = _free_port(), _free_port()
    proc = _child(["extender", "--config", str(tmp_path / "config.yaml"),
                   "--host", "127.0.0.1", "--port", str(port),
                   "--tls-cert", str(d / "server.crt"),
                   "--tls-key", str(d / "server.key"),
                   "--tls-client-ca", str(d / "ca.crt"),
                   "--probe-port", str(probe), "--kube-api", "off"])
    base, probe_base = f"https://127.0.0.1:{port}", f"http://127.0.0.1:{probe}"
    ok_ctx = ssl.create_default_context(cafile=str(d / "ca.crt"))
    ok_ctx.load_cert_chain(str(d / "client.crt"), str(d / "client.key"))
    anon_ctx = ssl.create_default_context(cafile=str(d / "ca.crt"))
    try:
        _wait_for(lambda: _get(f"{probe_base}/healthz")[0] == 200, proc,
                  "the probe port")
        assert _get(f"{base}/healthz", ok_ctx)[0] == 200
        # a client that stalls in its handshake holds only its own thread
        with socket.create_connection(("127.0.0.1", port)) as stalled:
            t = time.monotonic()
            assert _get(f"{base}/state/allocs", ok_ctx) == (200, b"[]")
            assert time.monotonic() - t < 5
            # no client certificate: refused at the handshake, nothing
            # served; the daemon goes on serving
            for _ in range(3):
                with pytest.raises(OSError):
                    _get(f"{base}/state/topology", anon_ctx)
            assert _get(f"{base}/healthz", ok_ctx)[0] == 200
            stalled.sendall(b"\x16\x03\x01")  # half a ClientHello
        # the probe port: /healthz and /metrics only
        assert b"tpu_chip_utilization_percent" in _get(f"{probe_base}/metrics")[1]
        for path in ("/state/topology", "/trace", "/statusz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{probe_base}{path}")
            assert e.value.code == 404
        # ctl over mTLS
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main_ctl(["--server", base, "--cacert", str(d / "ca.crt"),
                               "--cert", str(d / "client.crt"),
                               "--key", str(d / "client.key"), "topo"])
        assert rc == 0 and "alloc 0/0" in out.getvalue()
        with pytest.raises(OSError):
            cli.main_ctl(["--server", base, "--cacert", str(d / "ca.crt"),
                          "alloc"])
    finally:
        rc, err = _stop(proc)
    assert rc == 0
    assert "Traceback" not in err


def test_extender_daemon_refuses_bad_flag_sets(tmp_path):
    token = tmp_path / "empty"
    token.write_text("\n")
    for args in (["--tls-cert", "x.pem"], ["--tls-client-ca", "ca.pem"],
                 ["--auth-token-file", str(token)]):
        with pytest.raises(SystemExit):
            cli.main_extender([*args, "--kube-api", "off"])


# -- the plugin daemon (test_plugin_daemon.py) ---------------------------------

def test_plugin_daemon_full_lifecycle(tmp_path):
    from tpukube.core import codec as ref_codec
    from tpukube.plugin.fake_kubelet import FakeKubelet

    plugin_dir = tmp_path / "device-plugins"
    plugin_dir.mkdir()
    anno_path = tmp_path / "node-annotation.json"
    metrics_port = _free_port()
    with FakeKubelet(str(plugin_dir)) as kubelet:
        proc = _child(["plugin", "--metrics-port", str(metrics_port),
                       "--annotation-out", str(anno_path)], env={
            "TPUKUBE_BACKEND": "sim",
            "TPUKUBE_DEVICE_PLUGIN_DIR": str(plugin_dir),
            "TPUKUBE_SIM_MESH_DIMS": "2,2,1",
            "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        })
        try:
            kubelet.wait_for_devices("qiniu.com/tpu", 4, timeout=30)
            assert kubelet.allocatable("qiniu.com/tpu") == 4
            anno = _wait_for(lambda: anno_path.exists() and json.loads(
                anno_path.read_text()), proc, "the annotation file")
            node, mesh = ref_codec.node_from_annotations("host-0-0-0", anno)
            assert mesh.dims == (2, 2, 1) and len(node.chips) == 4
            env = kubelet.allocate("qiniu.com/tpu", ["tpu-1"])
            assert env["CUDA_VISIBLE_DEVICES"] == "1"
            assert "TPU_KUBE_CHIP_COORDS" in env
            status, raw = _get(f"http://127.0.0.1:{metrics_port}/statusz")
            doc = json.loads(raw)
            assert doc["component"] == "plugin"
            assert doc["devices"] == {"healthy": 4, "unhealthy": 0}
            assert doc["allocations"] == 1
            assert doc["telemetry"]["samples"] >= 0
            _, raw = _get(f"http://127.0.0.1:{metrics_port}/metrics")
            assert b"tpukube_plugin_allocations_total 1" in raw
        finally:
            rc, err = _stop(proc)
    assert rc == 0, err[-2000:]
