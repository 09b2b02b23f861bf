"""The port's device plugin (tpukube_torch/plugin/) held against the
reference's (tpukube/plugin/):

- the hand-written v1beta1 codec against the reference's protobuf
  messages, every message both ways, byte for byte under deterministic
  serialization (hypothesis, derandomized);
- peers across implementations over real gRPC unix sockets: the
  reference's FakeKubelet against the port's server, the port's
  FakeKubelet against the reference's server, each env equal to the
  reference-only run's (the port's under its CUDA names);
- the reference's tests/test_plugin.py (BASELINE config 1) and the
  telemetry plugin tests of tests/test_telemetry.py on both packages, the
  kubelet's view (device lists, preferences, envs, refusals) recorded on
  both sides and compared;
- the in-process transport (the card's) against the gRPC one: the same
  requests give the same responses.

test_telemetry.py's test_plugin_statusz_telemetry_section is twinned in
tests/test_torch_cli.py, and tests/test_plugin_daemon.py's daemon is
held in tests/test_torch_auth.py (``python -m tpukube_torch.cli
plugin``)."""

import contextlib
import re
import tempfile
import types

import grpc
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_plugin
import test_telemetry
from tpukube.core.config import load_config as ref_load_config
from tpukube.device import TpuDeviceManager
from tpukube.metrics import render_plugin_metrics as ref_render_plugin_metrics
from tpukube.obs.events import EventJournal as RefEventJournal
from tpukube.obs.health import HealthSampler as RefHealthSampler
from tpukube.obs.slo import validate_exposition
from tpukube.plugin import DevicePluginServer as RefPluginServer
from tpukube.plugin import FakeKubelet as RefFakeKubelet
from tpukube.plugin.proto import deviceplugin_pb2 as refpb
from tpukube_torch.core.config import load_config
from tpukube_torch.device import GpuDeviceManager
from tpukube_torch.device.gpu import (
    ENV_DEVICE_ORDER,
    ENV_KUBE_CORE_IDS,
    ENV_MEM_FRACTION,
    ENV_MPS_THREAD_PERCENTAGE,
    ENV_VISIBLE_DEVICES,
)
from tpukube_torch.metrics import render_plugin_metrics
from tpukube_torch.obs.events import EventJournal
from tpukube_torch.obs.health import HealthSampler
from tpukube_torch.plugin import (
    DevicePluginServer,
    FakeKubelet,
    HealthWatcher,
    InProcessKubelet,
    KubeletSessionWatcher,
    PluginRpcError,
    make_kubelet,
)
from tpukube_torch.plugin.proto import deviceplugin as dp
from torch_refnative import use_private_tpuinfo
from torch_twin import TMP_PATH, _call, _port_run, _rebind, reference_tests, run_twin

use_private_tpuinfo()

HBM = 16 << 30
PROTO = "tpukube_torch/plugin/proto/deviceplugin.proto"


def _renamed(ref_env: dict, cores: int = 2) -> dict:
    """The reference's env under the port's names (tests/test_torch_vgpu.py's
    renaming): CUDA visibility, and for shares the memory fraction under
    TPU_KUBE_MEM_FRACTION and MPS's SM percentage from the most
    constrained GPU's owned SMs (``cores`` SMs a GPU)."""
    out = dict(ref_env)
    out[ENV_VISIBLE_DEVICES] = out.pop("TPU_VISIBLE_DEVICES")
    out[ENV_DEVICE_ORDER] = "PCI_BUS_ID"
    if "XLA_PYTHON_CLIENT_MEM_FRACTION" in out:
        out[ENV_MEM_FRACTION] = out.pop("XLA_PYTHON_CLIENT_MEM_FRACTION")
    if ENV_KUBE_CORE_IDS in out:
        owned = [len(part.split(":")[1].split("+"))
                 for part in out[ENV_KUBE_CORE_IDS].split(";")]
        out[ENV_MPS_THREAD_PERCENTAGE] = str(min(owned) * 100 // cores)
    return out


# -- the codec against the reference's protobuf --------------------------------

TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=6)
_SCALARS = {
    dp.STRING: TEXT,
    dp.BOOL: st.booleans(),
    dp.INT32: st.integers(-(1 << 31), (1 << 31) - 1),
    dp.INT64: st.integers(-(1 << 63), (1 << 63) - 1),
    dp.REPEATED_STRING: st.lists(TEXT, max_size=4),
    dp.MAP: st.dictionaries(TEXT, TEXT, max_size=4),
}


def _values(cls, depth: int = 0):
    """A message's field values as a plain tree (a nested message is a
    dict, or None where a singular one is unset)."""
    fields = {}
    for _, name, kind, sub in cls._FIELDS:
        if kind == dp.MESSAGE:
            fields[name] = st.none() | _values(sub, depth + 1)
        elif kind == dp.REPEATED_MESSAGE:
            fields[name] = st.lists(_values(sub, depth + 1), max_size=3 - depth)
        else:
            fields[name] = _SCALARS[kind]
    return st.fixed_dictionaries(fields)


def _port_msg(cls, tree: dict):
    kw = {}
    for _, name, kind, sub in cls._FIELDS:
        v = tree[name]
        if kind == dp.MESSAGE:
            v = None if v is None else _port_msg(sub, v)
        elif kind == dp.REPEATED_MESSAGE:
            v = [_port_msg(sub, x) for x in v]
        kw[name] = v
    return cls(**kw)


def _ref_msg(cls, tree: dict):
    kw = {}
    for _, name, kind, sub in cls._FIELDS:
        v = tree[name]
        if kind == dp.MESSAGE:
            if v is None:
                continue
            v = _ref_msg(sub, v)
        elif kind == dp.REPEATED_MESSAGE:
            v = [_ref_msg(sub, x) for x in v]
        kw[name] = v
    return getattr(refpb, cls.__name__)(**kw)


# fields of numbers no v1beta1 message uses, of each wire type: varint,
# length-delimited, fixed64, fixed32 (what a newer kubelet may send)
UNKNOWN = (b"\x78\x96\x01" + b"\x82\x01\x03abc" + b"\x89\x01" + bytes(range(8))
           + b"\x95\x01" + bytes(range(4)))


@pytest.mark.parametrize("name", sorted(dp.MESSAGES))
def test_codec_agrees_with_protobuf_both_ways(name):
    cls = dp.MESSAGES[name]

    @settings(derandomize=True, database=None, max_examples=60, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(_values(cls))
    def check(tree):
        port, ref = _port_msg(cls, tree), _ref_msg(cls, tree)
        wire = port.encode()
        # the port's bytes parse to the same message in protobuf, and are
        # protobuf's own bytes under deterministic serialization
        assert type(ref).FromString(wire) == ref
        assert ref.SerializeToString(deterministic=True) == wire
        # protobuf's bytes (any map order) decode to the port's message
        assert cls.decode(ref.SerializeToString()) == port
        # fields this version does not know are skipped
        assert cls.decode(UNKNOWN + wire + UNKNOWN) == port

    check()


def _kind(field) -> str:
    repeated = field.is_repeated
    if field.type == field.TYPE_MESSAGE:
        if field.message_type.GetOptions().map_entry:
            return dp.MAP
        return dp.REPEATED_MESSAGE if repeated else dp.MESSAGE
    base = {field.TYPE_STRING: dp.STRING, field.TYPE_BOOL: dp.BOOL,
            field.TYPE_INT32: dp.INT32, field.TYPE_INT64: dp.INT64}[field.type]
    return dp.REPEATED_STRING if repeated and base == dp.STRING else base


def test_codec_covers_the_spec():
    # the .proto beside the codec declares exactly the codec's messages,
    # and each field has the reference descriptor's number, name and kind
    with open(PROTO) as f:
        declared = set(re.findall(r"^\s*message (\w+)", f.read(), re.M))
    assert declared == set(dp.MESSAGES) == set(refpb.DESCRIPTOR.message_types_by_name)
    for name, cls in dp.MESSAGES.items():
        desc = refpb.DESCRIPTOR.message_types_by_name[name]
        want = [(f.number, f.name, _kind(f)) for f in desc.fields]
        assert [(n, f, k) for n, f, k, _ in cls._FIELDS] == want, name
        for _, field, kind, sub in cls._FIELDS:
            if kind in (dp.MESSAGE, dp.REPEATED_MESSAGE):
                assert sub.__name__ == desc.fields_by_name[field].message_type.name


def test_codec_wire_details():
    # a negative int32 is a ten-byte varint; zero values are not written
    neg = dp.ContainerPreferredAllocationRequest(allocation_size=-1).encode()
    assert neg == b"\x18" + b"\xff" * 9 + b"\x01"
    assert dp.ContainerPreferredAllocationRequest.decode(neg).allocation_size == -1
    assert dp.DevicePluginOptions().encode() == b""
    # a set but empty message field is written; an unset one is not
    assert dp.RegisterRequest(options=dp.DevicePluginOptions()).encode() == b"\x22\x00"
    assert dp.RegisterRequest().encode() == b""
    # a message field that occurs twice is merged, as protobuf merges it
    twice = b"\x22\x02\x08\x01" + b"\x22\x02\x10\x01"
    assert dp.RegisterRequest.decode(twice).options == dp.DevicePluginOptions(True, True)
    assert refpb.RegisterRequest.FromString(twice).options == refpb.DevicePluginOptions(
        pre_start_required=True, get_preferred_allocation_available=True)
    with pytest.raises(ValueError, match="int32 range"):
        dp.ContainerPreferredAllocationRequest(allocation_size=1 << 31).encode()


@pytest.mark.parametrize("data", [
    b"\x0a\x05ab",           # truncated length-delimited field
    b"\x08",                 # truncated varint
    b"\x0b",                 # a group's wire type
    b"\x0a\x02\xff\xfe",     # invalid UTF-8 in a string
    b"\x08\x01",             # a string field sent as a varint
    b"\x00\x01",             # field number 0
])
def test_codec_refuses_malformed_bytes(data):
    with pytest.raises(dp.DecodeError):
        dp.RegisterRequest.decode(data)


# -- peers across implementations over gRPC unix sockets ------------------------

SESSION_ENV = {
    "TPUKUBE_BACKEND": "sim",
    "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    "TPUKUBE_HBM_BYTES_PER_CHIP": str(HBM),
    "TPUKUBE_CORES_PER_CHIP": "2",
}
REF_SIDE = (ref_load_config, TpuDeviceManager, RefPluginServer, RefFakeKubelet)
PORT_SIDE = (load_config, GpuDeviceManager, DevicePluginServer, FakeKubelet)


def _grpc_session(server_side, kubelet_cls) -> dict:
    """Register -> ListAndWatch -> GetPreferredAllocation -> Allocate (and a
    refused Allocate) with ``server_side``'s node agent and ``kubelet_cls``
    as the kubelet, over real unix sockets in a fresh directory."""
    load, manager, server_cls, _ = server_side
    with tempfile.TemporaryDirectory() as td:
        cfg = load(env={**SESSION_ENV, "TPUKUBE_DEVICE_PLUGIN_DIR": td})
        with kubelet_cls(td) as kubelet, manager(cfg, host="host-1-1-0") as device, \
                server_cls(cfg, device) as server:
            server.register_with_kubelet()
            devs = kubelet.wait_for_devices("qiniu.com/tpu", 4)
            pref = kubelet.preferred("qiniu.com/tpu", sorted(devs), 2, ["tpu-3"])
            env = kubelet.allocate("qiniu.com/tpu", pref)
            with pytest.raises(grpc.RpcError) as refused:
                kubelet.allocate("qiniu.com/tpu", ["tpu-99"])
            return {"devices": devs, "preferred": pref, "env": env,
                    "refused": refused.value.code(), "allocations": server.allocation_count}


@pytest.fixture(scope="module")
def reference_session():
    return _grpc_session(REF_SIDE, RefFakeKubelet)


def test_reference_kubelet_allocates_through_the_port_server(reference_session):
    got = _grpc_session(PORT_SIDE, RefFakeKubelet)
    want = reference_session
    assert got["devices"] == want["devices"]
    assert got["preferred"] == want["preferred"]
    assert got["env"] == _renamed(want["env"])
    assert got["refused"] == want["refused"] == grpc.StatusCode.INVALID_ARGUMENT
    assert got["allocations"] == want["allocations"] == 1


def test_port_kubelet_allocates_through_the_reference_server(reference_session):
    got = _grpc_session(REF_SIDE, FakeKubelet)
    assert got == reference_session


# -- the reference's plugin and telemetry tests on both packages ------------------

def _recording(base, log: list, rename):
    """``base`` (a kubelet class) logging what the kubelet sees: device
    lists, preferences, envs (under the port's names) and refusals."""

    class Recorder(base):
        def wait_for_devices(self, resource_name, count, *a, **kw):
            devs = super().wait_for_devices(resource_name, count, *a, **kw)
            log.append(("devices", resource_name, sorted(devs.items())))
            return devs

        def preferred(self, resource_name, available, size, *a, **kw):
            got = super().preferred(resource_name, available, size, *a, **kw)
            log.append(("preferred", resource_name, list(available), size, list(got)))
            return got

        def allocate(self, resource_name, device_ids, *a, **kw):
            try:
                env = super().allocate(resource_name, device_ids, *a, **kw)
            except grpc.RpcError as e:
                log.append(("refused", resource_name, list(device_ids), e.code().name))
                raise
            log.append(("allocate", resource_name, list(device_ids), rename(env)))
            return env

    return Recorder


def _body_fixture(module, name: str, tmp: bool = False):
    """A reference module's pytest fixture as a twin fixture: its body
    rebuilt over the twin run's remapped globals, given a fresh
    ``tmp_path`` when it takes one."""
    body = vars(module)[name]._get_wrapped_function()

    def fixture(g):
        gen = contextlib.contextmanager(types.FunctionType(body.__code__, g, body.__name__))

        @contextlib.contextmanager
        def run():
            with contextlib.ExitStack() as stack:
                args = [stack.enter_context(TMP_PATH["tmp_path"](g))] if tmp else []
                yield stack.enter_context(gen(*args))
        return run()
    return fixture


def run_plugin_twin(fn, fixtures: dict) -> list:
    """``run_twin`` for node-agent tests: each side's FakeKubelet records
    what the kubelet sees, the port's side reads the port's env key names,
    and the two logs must be equal (the reference's envs renamed)."""
    logs = {}
    for port in (False, True):
        log: list = []
        f = _rebind(fn, port, log)
        g = f.__globals__
        g["FakeKubelet"] = _recording(g["FakeKubelet"], log,
                                      (lambda env: env) if port else _renamed)
        if port:
            g["ENV_VISIBLE_DEVICES"] = ENV_VISIBLE_DEVICES
        with _port_run() if port else contextlib.nullcontext():
            _call(f, fixtures)
        logs[port] = log
    assert logs[True] == logs[False]
    return logs[False]


PLUGIN_FIXTURES = {"stack": _body_fixture(test_plugin, "stack", tmp=True), **TMP_PATH}


@pytest.mark.parametrize("fn", reference_tests(test_plugin, {}), ids=lambda f: f.__name__)
def test_reference_plugin_tests_hold_on_the_port(fn):
    log = run_plugin_twin(fn, PLUGIN_FIXTURES)
    assert any(entry[0] == "devices" for entry in log)  # the kubelet saw the plugin


def test_reference_sampler_test_holds_on_the_port():
    run_twin(test_telemetry.test_sampler_detects_chip_and_link_transitions, TMP_PATH)


def _plugin_page(load, manager, server_cls, sampler_cls, journal_cls, render) -> str:
    """test_telemetry's test_plugin_metrics_carry_per_chip_series on one
    package: the plugin's page after a baseline sample and a fault."""
    with tempfile.TemporaryDirectory() as td:
        cfg = load(env={"TPUKUBE_BACKEND": "sim", "TPUKUBE_DEVICE_PLUGIN_DIR": td,
                        "TPUKUBE_SIM_MESH_DIMS": "2,2,1",
                        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                        "TPUKUBE_HBM_BYTES_PER_CHIP": str(95 << 30),
                        "TPUKUBE_CORES_PER_CHIP": "2"})
        with manager(cfg) as device, server_cls(cfg, device) as server:
            journal = journal_cls()
            sampler = sampler_cls(device, journal=journal, poll_seconds=999)
            sampler.check_once()
            device.inject_fault(2)
            sampler.check_once()
            return render(server, sampler=sampler, events=journal)


def test_plugin_metrics_render_as_the_reference():
    """Twin of test_telemetry.py's test_plugin_metrics_carry_per_chip_series:
    the port's page is the reference's but for the HELP text (which names
    GPUs and NVML), its per-GPU series are those the reference test asks
    for, and it lints clean under the reference's exposition lint."""
    text = _plugin_page(load_config, GpuDeviceManager, DevicePluginServer,
                        HealthSampler, EventJournal, render_plugin_metrics)
    ref = _plugin_page(ref_load_config, TpuDeviceManager, RefPluginServer,
                       RefHealthSampler, RefEventJournal, ref_render_plugin_metrics)

    def unhelped(page):
        return [line for line in page.splitlines() if not line.startswith("# HELP ")]

    assert unhelped(text) == unhelped(ref)
    assert [line.split(" ")[2] for line in text.splitlines() if line.startswith("# HELP ")] \
        == [line.split(" ")[2] for line in ref.splitlines() if line.startswith("# HELP ")]
    assert 'tpukube_chip_healthy{chip="tpu-0"} 1\n' in text
    assert 'tpukube_chip_healthy{chip="tpu-2"} 0\n' in text
    assert 'tpukube_chip_ici_link_errors_total{chip="tpu-0"} 0\n' in text
    assert 'tpukube_chip_health_transitions_total{chip="tpu-2"} 1\n' in text
    assert 'tpukube_node_chips{state="unhealthy"} 1\n' in text
    assert 'tpukube_events_total{reason="ChipUnhealthy"} 1\n' in text
    assert 'tpukube_plugin_devices{health="Healthy"} 3\n' in text
    assert validate_exposition(text) == []


# -- the in-process transport against gRPC ----------------------------------------

def _config1(transport: str) -> list:
    """Config 1 over ``transport``: Register -> ListAndWatch -> Allocate,
    a preference, a refused Allocate, then the health-fault shrink and
    recovery. Returns what the kubelet saw, in order."""
    seen: list = []
    with tempfile.TemporaryDirectory() as td:
        cfg = load_config(env={**SESSION_ENV, "TPUKUBE_DEVICE_PLUGIN_DIR": td})
        with GpuDeviceManager(cfg, host="host-0-0-0") as device, \
                make_kubelet(transport, td) as kubelet:
            server = DevicePluginServer(cfg, device)
            watcher = HealthWatcher(device, server, poll_seconds=999)
            watcher.start()
            kubelet.register_plugin(server)
            req = kubelet.registration("qiniu.com/tpu")
            seen.append(("register", req.version, req.endpoint, req.resource_name,
                         req.options.get_preferred_allocation_available))
            seen.append(kubelet.wait_for_devices("qiniu.com/tpu", 4))
            seen.append(kubelet.preferred("qiniu.com/tpu", ["tpu-0", "tpu-1",
                                                            "tpu-2", "tpu-3"], 2))
            seen.append(kubelet.allocate("qiniu.com/tpu", ["tpu-0"]))
            try:
                kubelet.allocate("qiniu.com/tpu", ["tpu-99"])
            except PluginRpcError as e:  # in process: the handler's own error
                seen.append(("refused", e.code))
            except grpc.RpcError as e:
                seen.append(("refused", e.code().name))
            device.inject_fault(2)
            seen.append(watcher.check_once())
            kubelet.wait_for_health("qiniu.com/tpu", "tpu-2", "Unhealthy")
            seen.append((kubelet.devices("qiniu.com/tpu"),
                         kubelet.allocatable("qiniu.com/tpu")))
            device.inject_fault(2, healthy=True)
            seen.append(watcher.check_once())
            kubelet.wait_for_health("qiniu.com/tpu", "tpu-2", "Healthy")
            seen.append(kubelet.allocatable("qiniu.com/tpu"))
            seen.append(server.allocation_count)
            watcher.stop()
    return seen


def test_inprocess_transport_answers_as_grpc():
    inproc, over_grpc = _config1("inprocess"), _config1("grpc")
    assert inproc == over_grpc
    assert inproc[0] == ("register", "v1beta1", "tpukube.sock", "qiniu.com/tpu", True)
    assert ("refused", "INVALID_ARGUMENT") in inproc
    assert inproc[-2] == 4


def test_inprocess_kubelet_crosses_encoded_bytes(monkeypatch):
    # every request and response of the in-process peer goes through the
    # codec: count the encodes of one Register -> ListAndWatch -> Allocate
    encoded: list = []
    real = dp.Message.encode

    def counting(self):
        encoded.append(type(self).__name__)
        return real(self)

    monkeypatch.setattr(dp.Message, "encode", counting)
    with tempfile.TemporaryDirectory() as td:
        cfg = load_config(env={**SESSION_ENV, "TPUKUBE_DEVICE_PLUGIN_DIR": td})
        with InProcessKubelet() as kubelet, GpuDeviceManager(cfg) as device:
            server = DevicePluginServer(cfg, device)
            kubelet.register_plugin(server)
            kubelet.wait_for_devices("qiniu.com/tpu", 4)
            kubelet.allocate("qiniu.com/tpu", ["tpu-1"])
    for name in ("RegisterRequest", "Empty", "ListAndWatchResponse",
                 "AllocateRequest", "AllocateResponse"):
        assert name in encoded, name


@pytest.mark.parametrize("cap,timeouts", [("0", [{}]), ("0.5", [{"timeout": 0.5}]),
                                          ("60", [{"timeout": 5.0}])])
def test_registration_attempt_timeout_follows_the_retry_policy(tmp_path, cap, timeouts):
    # TPUKUBE_RETRY_ATTEMPT_TIMEOUT_SECONDS caps each Register's gRPC
    # timeout (0 = the transport's own 5 s)
    cfg = load_config(env={"TPUKUBE_DEVICE_PLUGIN_DIR": str(tmp_path),
                           "TPUKUBE_RETRY_ATTEMPT_TIMEOUT_SECONDS": cap})
    open(cfg.kubelet_socket_path(), "w").close()
    calls: list = []
    server = types.SimpleNamespace(
        config=cfg, socket_path=cfg.kubelet_socket_path(),
        register_with_kubelet=lambda **kw: calls.append(kw),
    )
    watcher = KubeletSessionWatcher(server, poll_seconds=999)
    watcher.mark_unregistered()
    assert watcher.check_once() is True
    assert calls == timeouts


def test_unknown_transport_is_refused():
    with pytest.raises(ValueError, match="unknown plugin transport"):
        make_kubelet("shm")
