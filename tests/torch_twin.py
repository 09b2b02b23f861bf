"""Twin runs of the reference's scheduler tests: one test body, run once
against the reference and once against the port, with every scheduling
decision recorded on both sides and compared.

A reference test function is rebuilt with its module's globals remapped:
``SimCluster`` and ``ChaosSimCluster`` become recording subclasses (the
reference's run in-process, ``Extender.handle`` without HTTP), and for the
port's run every
class, function and module of ``tpukube.*`` becomes its namesake in
``tpukube_torch.*``. For the length of the port's run, ``sys.modules``
maps every ``tpukube.*`` module to a stand-in that hands out the port's
namesakes (``TpuDeviceManager`` is ``GpuDeviceManager``,
``tpukube.device.tpu`` is ``tpukube_torch.device.gpu``), so an import in
the test's body reaches the port too; a name the port lacks fails the
test, and so does building the reference's sim, extender, cluster state,
gang manager, device manager, device-plugin server or fake kubelet. The
test's own assertions then run on both sides, and the two decision logs
(pod, node, device ids, coords, env, or the error) must be equal. The
port's config gets the reference's sim defaults (sim backend, mesh, HBM,
cores per chip), so both sides mint the same fleet. A reference test
double that stands for the apiserver, not for code under test
(``SHARED_DOUBLES``), is handed to both runs as it is.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import pathlib
import sys
import tempfile
import types
from typing import Any, Callable, Optional

from tpukube.chaos import ChaosSimCluster as RefChaosSim
from tpukube.core.config import TpuKubeConfig as RefConfig
from tpukube.device import TpuDeviceManager as RefDeviceManager
from tpukube.plugin import DevicePluginServer as RefPluginServer
from tpukube.plugin import FakeKubelet as RefFakeKubelet
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sched.gang import GangManager as RefGangManager
from tpukube.sched.state import ClusterState as RefClusterState
from tpukube.sim import SimCluster as RefSim
from tpukube.sched.shard import _ListApi as RefListApi
from tpukube_torch.chaos import ChaosSimCluster as PortChaosSim
from tpukube_torch.core import config as port_config
from tpukube_torch.sim import SimCluster as PortSim

# the reference's sim defaults (tpukube/core/config.py), given to both
# sides so the port mints the same fleet as the reference
REF_SIM_DEFAULTS = {
    "TPUKUBE_BACKEND": "sim",
    "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    "TPUKUBE_HBM_BYTES_PER_CHIP": str(95 * 1024**3),
    "TPUKUBE_CORES_PER_CHIP": "2",
}


def port_load_config(yaml_path: Optional[str] = None,
                     env: Optional[dict] = None):
    """The port's ``load_config`` with the reference's sim defaults where
    neither the file nor ``env`` sets the field (the defaults sit under
    the file, as the reference's own defaults do)."""
    in_file = set(port_config.read_yaml(yaml_path)) if yaml_path else set()
    defaults = {k: v for k, v in REF_SIM_DEFAULTS.items()
                if k[len(port_config.ENV_PREFIX):].lower() not in in_file}
    return port_config.load_config(
        yaml_path=yaml_path, env={**defaults, **(env or {})})


def _pod_key(pod: dict) -> str:
    meta = pod["metadata"]
    return f"{meta.get('namespace', 'default')}/{meta['name']}"


class _Recording:
    """Mixin: log every schedule() and schedule_pending() outcome and
    every utilization() reading; let the journal drain after each pod's
    schedule, completion or deletion and before a crash."""

    log: list

    def schedule(self, pod, retries: int = 8):
        try:
            node, alloc = super().schedule(pod, retries)
        except RuntimeError as e:
            self.log.append((_pod_key(pod), "error", str(e)))
            raise
        finally:
            self._drain_journal()
        self.log.append((_pod_key(pod), node, list(alloc.device_ids),
                         [tuple(c) for c in alloc.coords], dict(alloc.env),
                         alloc.priority, alloc.uid))
        return node, alloc

    def schedule_pending(self, pods, retries: int = 4):
        try:
            results = super().schedule_pending(pods, retries)
        except RuntimeError as e:
            self.log.append(("pending", "error", str(e)))
            raise
        for key, (node, alloc) in results.items():
            self.log.append(("pending", key, node, list(alloc.device_ids),
                             [tuple(c) for c in alloc.coords]))
        return results

    def utilization(self) -> float:
        u = super().utilization()
        self.log.append(("utilization", u))
        return u

    def drain_evictions(self) -> list:
        done = super().drain_evictions()
        if done:
            self.log.append(("evicted", sorted(done)))
        return done

    def _drain_journal(self) -> None:
        # the reference's own tests run their sim over HTTP, whose round
        # trips let the journal's drain thread land each decision's
        # records before the test reads the files or crashes the
        # extender; a twin dispatches in process, so both sides let the
        # drain catch up (a test that wants records lost drops them from
        # the file itself)
        journal = getattr(self.extender, "journal", None)
        if journal is not None:
            journal.sync()

    def complete_pod(self, *args, **kw) -> None:
        super().complete_pod(*args, **kw)
        self._drain_journal()

    def delete_pod(self, *args, **kw) -> None:
        super().delete_pod(*args, **kw)
        self._drain_journal()

    def crash_extender(self) -> None:
        self._drain_journal()
        super().crash_extender()


class _RefRecorder(_Recording, RefSim):
    def __init__(self, *args, **kw):
        kw["in_process"] = True
        super().__init__(*args, **kw)


class _RefServingRecorder(_Recording, RefSim):
    """The reference's SimCluster over its own HTTP app (for tests that
    scrape ``base_url``)."""


class _RefChaosRecorder(_Recording, RefChaosSim):
    def __init__(self, *args, **kw):
        kw["in_process"] = True
        super().__init__(*args, **kw)


class _PortChaosRecorder(_Recording, PortChaosSim):
    pass


class _PortSim(PortSim):
    """The port's SimCluster under the reference's constructor, with the
    reference's sim defaults when no config is given."""

    def __init__(self, config=None, *args, **kw):
        super().__init__(config if config is not None else port_load_config(),
                         *args, **kw)


class _PortRecorder(_Recording, _PortSim):
    pass


# reference objects that stand for the apiserver, not for code under
# test: the shard module's list-backed read surface, which the
# reference's journal tests hand the recovery (the shard router itself
# is not ported)
SHARED_DOUBLES = (RefListApi,)


class PortLacks(LookupError):
    """A reference name with no namesake in the port."""


# reference modules whose port has another name, and reference names
# whose namesake in the port has another name
MODULE_ALIASES = {"tpukube.device.tpu": "tpukube_torch.device.gpu"}
NAME_ALIASES = {"TpuKubeConfig": "GpuKubeConfig",
                "TpuDeviceManager": "GpuDeviceManager"}


def _port_module(ref_name: str) -> types.ModuleType:
    name = MODULE_ALIASES.get(ref_name, "tpukube_torch" + ref_name[len("tpukube"):])
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is not None and not name.startswith(e.name):
            raise
        raise PortLacks(f"the port has no module {name}") from None


def _port_value(name: str, val: Any) -> Any:
    """The port's namesake of a reference global (unchanged if it is not
    of the reference); raises ``PortLacks`` when the port has none."""
    if val is RefSim:
        return _PortSim
    if any(val is d for d in SHARED_DOUBLES):
        return val
    if name == "load_config" and getattr(val, "__module__", "") == "tpukube.core.config":
        return port_load_config
    if isinstance(val, RefConfig):
        # a module-level config of the reference's defaults: the port's
        # defaults (its own card, its own backend), not the sim's
        if val != RefConfig():
            raise PortLacks(f"{name}: only a default config has a namesake")
        return port_config.GpuKubeConfig()
    if isinstance(val, types.ModuleType):
        if val.__name__ == "tpukube" or val.__name__.startswith("tpukube."):
            return _port_module(val.__name__)
        return val
    mod = getattr(val, "__module__", None)
    if isinstance(mod, str) and mod.startswith("tpukube.") and hasattr(val, "__name__"):
        alias = NAME_ALIASES.get(val.__name__, val.__name__)
        port_mod = _port_module(mod)
        try:
            return getattr(port_mod, alias)
        except AttributeError:
            raise PortLacks(f"the port has no {port_mod.__name__}.{alias}") from None
    return val


class _Lacking:
    """A reference global the port has no namesake for: any use of it
    fails the port's run."""

    def __init__(self, why: str):
        self._why = why

    def __getattr__(self, attr):
        raise AssertionError(self._why)

    def __call__(self, *args, **kw):
        raise AssertionError(self._why)


class _PortModule(types.ModuleType):
    """Stands in for reference module ``ref`` in ``sys.modules`` during the
    port's run: ``from tpukube.x import y`` gets the port's ``y``."""

    def __init__(self, ref: types.ModuleType):
        super().__init__(ref.__name__)
        self._ref = ref

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        val = vars(self._ref).get(attr, self)
        try:
            if val is self or isinstance(val, types.ModuleType):
                return _port_module(f"{self._ref.__name__}.{attr}")
            return _port_value(attr, val)
        except PortLacks as e:
            raise ImportError(str(e)) from None


def _refuse(self, *args, **kw):
    raise AssertionError(
        f"the port's run built the reference's {type(self).__name__}")


@contextlib.contextmanager
def _port_run():
    """Imports of ``tpukube.*`` reach the port, and the reference's
    scheduler and node-agent objects cannot be built, until the block
    exits."""
    refs = {n: m for n, m in sys.modules.items()
            if n == "tpukube" or n.startswith("tpukube.")}
    guarded = (RefSim, RefExtender, RefClusterState, RefGangManager,
               RefDeviceManager, RefPluginServer, RefFakeKubelet)
    inits = [cls.__dict__["__init__"] for cls in guarded]
    sys.modules.update({n: _PortModule(m) for n, m in refs.items()})
    for cls in guarded:
        cls.__init__ = _refuse
    try:
        yield
    finally:
        sys.modules.update(refs)
        for cls, init in zip(guarded, inits):
            cls.__init__ = init


def _rebind(fn: Callable, port: bool, log: list,
            serve_ref: bool = False,
            overrides: Optional[dict] = None) -> Callable:
    """``fn`` with its module's globals remapped (helper functions and
    classes of the same module rebuilt over the same remapped globals);
    ``overrides`` replaces globals by name after the remapping."""
    g = dict(fn.__globals__)
    base = (_PortRecorder if port
            else _RefServingRecorder if serve_ref else _RefRecorder)
    sim = type("Rec", (base,), {"log": log})
    chaos = type("ChaosRec", (_PortChaosRecorder if port
                              else _RefChaosRecorder,), {"log": log})
    for name, val in list(g.items()):
        if val is RefSim:
            g[name] = sim
        elif val is RefChaosSim:
            g[name] = chaos
        elif port:
            try:
                g[name] = _port_value(name, val)
            except PortLacks as e:
                g[name] = _Lacking(str(e))
    g.update(overrides or {})
    for name, val in list(g.items()):
        if (isinstance(val, types.FunctionType)
                and val.__module__ == fn.__module__):
            g[name] = _over(val, g)
        elif isinstance(val, type) and val.__module__ == fn.__module__:
            # a helper class of the test module (a mutation driver): its
            # methods read the same remapped globals
            ns = {k: _over(v, g) if isinstance(v, types.FunctionType) else v
                  for k, v in vars(val).items()
                  if k not in ("__dict__", "__weakref__")}
            g[name] = type(val.__name__, val.__bases__, ns)
    return _over(fn, g)


def _over(fn: types.FunctionType, g: dict) -> types.FunctionType:
    """``fn`` rebuilt over globals ``g``."""
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@contextlib.contextmanager
def _tmp_path():
    # pytest keeps a test's tmp_path after the test; a journal a test
    # leaves open may still be landing a checkpoint there when the
    # directory goes, so its removal is best effort
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as td:
        yield pathlib.Path(td)


# pytest's tmp_path, as a twin fixture: a fresh directory for each side
TMP_PATH = {"tmp_path": lambda g: _tmp_path()}


def _call(fn: Callable, fixtures: dict[str, Callable]) -> None:
    params = inspect.signature(fn).parameters
    with contextlib.ExitStack() as stack:
        kwargs = {}
        for name in params:
            kwargs[name] = stack.enter_context(fixtures[name](fn.__globals__))
        fn(**kwargs)


def _placed(log: list) -> list:
    """The pods a log bound and the chips each took, order-free (for tests
    whose binds race: which chip a racing pod lands on, and whether a
    concurrently deleted pod's chip is bound again, hang on the race)."""
    return sorted((entry[0], len(entry[2])) for entry in log
                  if len(entry) == 7)


def run_twin(fn: Callable, fixtures: Optional[dict] = None,
             ordered: bool = True, serve_ref: bool = False) -> list:
    """Run reference test ``fn`` against the reference, then the port;
    assert the decision logs are equal (``ordered=False``: the pods bound
    and their chip counts, for a test whose threads race each other). ``fixtures`` maps a
    parameter name to ``globals -> context manager``; ``serve_ref`` runs
    the reference's SimCluster over its HTTP app (the port's always
    serves inside ``with``). Returns the reference log."""
    ref_log: list = []
    port_log: list = []
    _call(_rebind(fn, False, ref_log, serve_ref), fixtures or {})
    with _port_run():
        _call(_rebind(fn, True, port_log), fixtures or {})
    if ordered:
        assert port_log == ref_log
    else:
        assert _placed(port_log) == _placed(ref_log)
    return ref_log


def run_port(fn: Callable, fixtures: Optional[dict] = None,
             port_globals: Optional[dict] = None) -> list:
    """Run reference test ``fn`` against the port alone, its globals
    remapped as for ``run_twin`` and then ``port_globals`` over them (a
    path the test names, given as the port's). For tests whose
    reference run their own module already makes and whose outcome is
    the port's verdict, not a decision log to compare (the lint
    prover's). Returns the port's decision log."""
    log: list = []
    with _port_run():
        _call(_rebind(fn, True, log, overrides=port_globals), fixtures or {})
    return log


def reference_tests(module, skip: dict[str, str]) -> list:
    """The module's ``test_*`` functions, minus ``skip`` (name -> why)."""
    names = [n for n, v in vars(module).items()
             if n.startswith("test_") and isinstance(v, types.FunctionType)]
    unknown = set(skip) - set(names)
    assert not unknown, f"skip names no test of {module.__name__}: {unknown}"
    return [vars(module)[n] for n in names if n not in skip]


def reference_cases(module, skip: dict[str, str]) -> list:
    """``reference_tests``' functions, one ``pytest.param(fn, kwargs)``
    per case of their ``parametrize`` marks (kwargs maps each
    parametrized argument to its value; ``{}`` for a plain test). Feed
    the kwargs to ``run_twin`` through :func:`value_fixtures`."""
    import pytest

    cases = []
    for fn in reference_tests(module, skip):
        combos: list[tuple[dict, list[str]]] = [({}, [])]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names = mark.args[0]
            if isinstance(names, str):
                names = [n.strip() for n in names.split(",")]
            ids = mark.kwargs.get("ids")
            combos = [
                ({**kw, **dict(zip(names, v if len(names) > 1 else (v,)))},
                 tags + [str(ids[i]) if ids is not None else str(v)])
                for kw, tags in combos
                for i, v in enumerate(mark.args[1])
            ]
        for kw, tags in combos:
            cases.append(pytest.param(
                fn, kw, id="-".join([fn.__name__, *tags])))
    return cases


def value_fixtures(values: dict) -> dict:
    """Twin fixtures that hand each parametrized argument its value."""
    return {name: (lambda g, v=v: contextlib.nullcontext(v))
            for name, v in values.items()}

