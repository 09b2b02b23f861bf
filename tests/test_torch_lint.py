"""The port's lint prover (``tpukube_torch/analysis``: the static passes,
the waiver mechanism, the CLI and the rules-file reader) held against the
reference's.

Twins (``run_port``: each reference test's body on the port, its
``tpukube.analysis`` imports reaching ``tpukube_torch.analysis``):
test_lint.py's static tests but those named in ``LINT_SKIPS``, each with
its reason and stand-in; the tree-level tests lint ``tpukube_torch/``
(``TREE`` given as the port's tree). The reference's own run of each body
is test_lint.py's. The lock-order monitor's tests are twinned in
tests/test_torch_lockgraph.py, test_cfg.py's in tests/test_torch_cfg.py.

The port's own: both linters give the same (rule, path, line) findings
on every fixture of the twinned tests and on the port's tree (none);
every path suffix a pass scopes itself by names a file, class and
function of the port; the registries equal the reference's but the
differences named in ``REGISTRY_DIFFERENCES``; the rules-file reader
against PyYAML; the CLI with no YAML library."""

import ast
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

import test_cfg
import test_decisions
import test_lint
from tpukube.analysis import base as ref_base
from tpukube.analysis import flags as ref_flags
from tpukube.analysis import seams as ref_seams
from tpukube_torch.analysis import (
    base,
    consistency,
    epochs,
    flags,
    leaks,
    locks,
    lockgraph,
    provenance,
    rulesyaml,
    seams,
)
from tpukube_torch.analysis.cli import main
from test_torch_cli import _capsys
from torch_twin import TMP_PATH, reference_tests, run_port

# every module of the reference's analysis package, imported so that an
# import in a twinned body finds its stand-in during the port's run
REF_ANALYSIS = ("base", "callgraph", "cfg", "cli", "consistency", "epochs",
                "flags", "hygiene", "leaks", "lockgraph", "locks",
                "provenance", "seams")
for _name in REF_ANALYSIS:
    importlib.import_module(f"tpukube.analysis.{_name}")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = os.path.join(REPO, "tpukube_torch")
RULES_FILE = os.path.join(REPO, "deploy", "prometheus-rules.yaml")

# the monitor's tests (tests/test_torch_lockgraph.py twins them)
DYNAMIC = (
    "test_monitor_off_by_default",
    "test_monitor_records_and_detects_seeded_inversion",
    "test_monitor_sees_dataclass_default_factory_locks",
    "test_monitor_cross_thread_release_leaves_no_phantom_edges",
    "test_monitor_reentrant_rlock_is_not_an_edge",
    "test_monitor_unwinds_when_cluster_constructor_fails",
    "test_dynamic_detector_clean_across_sim_scenarios",
    "test_dynamic_detector_concurrent_stress_via_config_flag",
    "test_federated_lockgraph_merges_fleet_and_is_clean",
    "test_federated_lockgraph_off_is_off",
)
LINT_SKIPS = {
    "test_shipped_cycle_module_is_snapshot_disciplined":
        "lints the reference's tpukube/sched/cycle.py by path; "
        "test_shipped_cycle_module_is_snapshot_disciplined_on_the_port "
        "lints the port's",
    **{name: "the lock-order monitor: tests/test_torch_lockgraph.py"
       for name in DYNAMIC},
}
FIXTURES = {**TMP_PATH, "capsys": lambda g: _capsys()}


@pytest.mark.parametrize("fn", reference_tests(test_lint, LINT_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_lint_tests_hold_on_the_port(fn):
    run_port(fn, FIXTURES, port_globals={"TREE": PORT_TREE})


def test_shipped_cycle_module_is_snapshot_disciplined_on_the_port():
    path = os.path.join(PORT_TREE, "sched", "cycle.py")
    sf = base.SourceFile(path, rel="sched/cycle.py")
    assert base.apply_waivers(
        sf, consistency.check_snapshot_discipline(sf)) == []


# -- both linters, finding for finding -----------------------------------------

def _fixture_sources() -> dict:
    """Every Python fixture the twinned tests lint: the string constants of
    test_lint.py, test_cfg.py and test_decisions.py that parse as a module
    defining a function or class (dedented, as the tests dedent them)."""
    out = {}
    for mod in (test_lint, test_cfg, test_decisions):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            src = textwrap.dedent(node.value)
            if "def " not in src and "class " not in src:
                continue
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out[f"{mod.__name__}-{node.lineno}"] = src
    return out


def _scope_suffixes() -> list:
    """Every path suffix a pass of the port scopes itself by."""
    out = set(locks.DISCIPLINE_SCOPE) | set(consistency.SNAPSHOT_HOME)
    out |= {consistency.CYCLE_HOME, "core/config.py"}
    out |= set(consistency._REGISTRY_DECLS) | set(seams.REQUIRED_KINDS)
    out |= set(provenance.SCOPE) | set(provenance.SEAMS)
    for table in (locks.CLASS_DISCIPLINE, locks.ORDERED_LOCKS,
                  locks.CALL_ROOTS, locks.SELF_METHODS, locks.GUARDED_ATTRS,
                  locks.EXTERNALLY_LOCKED_ROOTS, epochs.EPOCH_REGISTRY,
                  leaks.LEAK_REGISTRY, seams.TRIPLE_REGISTRY):
        out |= {key[0] for key in table}
    for spec in flags.FLAG_REGISTRY:
        out |= set(spec.construct_scope) | {sfx for sfx, _ in spec.consumers}
    return sorted(out)


def _keys(findings) -> list:
    return sorted((f.rule, f.path, f.line) for f in findings)


def test_both_linters_agree_on_every_fixture(tmp_path, monkeypatch):
    # each fixture under every scoped path, and as a plain module: one
    # tree, one run of each linter over it, equal (rule, path, line)s
    monkeypatch.chdir(tmp_path)
    sources = _fixture_sources()
    assert len(sources) >= 60
    paths = _scope_suffixes() + ["sched/ledger.py", "sched/widgets.py",
                                 "mod.py"]
    for i, src in enumerate(sources.values()):
        for rel in paths:
            f = tmp_path / f"f{i}" / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(src)
    got = base.run_all([tmp_path])
    want = ref_base.run_all([tmp_path])
    assert _keys(got) == _keys(want)
    assert len(got) > 200
    # the fixture registries the seam-triple and flag tests pass in
    ref_seam = test_lint._seam_registry()
    port_seam = {k: seams.TripleSpec(**dataclasses.asdict(v))
                 for k, v in ref_seam.items()}
    ref_flag = test_lint._flag_registry()
    port_flag = tuple(flags.FlagSpec(**dataclasses.asdict(s))
                      for s in ref_flag)
    n = 0
    for i, src in enumerate(sources.values()):
        for rel in ("sched/ledger.py", "sched/widgets.py", "core/config.py"):
            path = tmp_path / f"f{i}" / rel
            sf = base.SourceFile(path, rel=rel)
            rsf = ref_base.SourceFile(path, rel=rel)
            got = (seams.check_seam_triples(sf, registry=port_seam)
                   + flags.check_flags(sf, registry=port_flag))
            want = (ref_seams.check_seam_triples(rsf, registry=ref_seam)
                    + ref_flags.check_flags(rsf, registry=ref_flag))
            assert _keys(got) == _keys(want), (i, rel)
            n += len(got)
    assert n > 0


def test_both_linters_find_the_port_tree_clean():
    assert base.run_all([PORT_TREE]) == []
    assert ref_base.run_all([PORT_TREE]) == []


# -- every rule has something to check ------------------------------------------

def _classes(path: str) -> dict:
    tree = ast.parse(open(path).read())
    return {c.name: {f.name for f in c.body
                     if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for c in tree.body if isinstance(c, ast.ClassDef)}


def _port_files(suffix: str) -> list:
    out = []
    for d, _, files in os.walk(PORT_TREE):
        for f in files:
            p = os.path.join(d, f)
            if f.endswith(".py") and p.replace(os.sep, "/").endswith(suffix):
                out.append(p)
    return out


def test_every_scope_names_a_file_class_and_function_of_the_port():
    for suffix in _scope_suffixes():
        assert _port_files(suffix), f"{suffix} matches no file of the port"
    keyed = []
    for table in (locks.CLASS_DISCIPLINE, locks.ORDERED_LOCKS,
                  locks.CALL_ROOTS, locks.SELF_METHODS, locks.GUARDED_ATTRS,
                  locks.EXTERNALLY_LOCKED_ROOTS, epochs.EPOCH_REGISTRY,
                  seams.TRIPLE_REGISTRY):
        keyed += [(sfx, cls, None) for sfx, cls in table]
    keyed += list(leaks.LEAK_REGISTRY)
    for spec in flags.FLAG_REGISTRY:
        keyed += [(sfx, cls, None) for sfx, cls in spec.consumers]
    for sfx, cls, func in keyed:
        found = [_classes(p) for p in _port_files(sfx)]
        assert any(cls in c for c in found), f"no class {cls} in {sfx}"
        if func is not None:
            assert any(func in c.get(cls, ()) for c in found), \
                f"no {cls}.{func} in {sfx}"
    for sfx, names in provenance.SEAMS.items():
        for p in _port_files(sfx):
            defined = {n.name for n in ast.walk(ast.parse(open(p).read()))
                       if isinstance(n, ast.FunctionDef)}
            assert names <= defined, (sfx, names - defined)
    # flag-discipline's construction scopes each construct their flag's
    # subsystem under the flag, and the lock monitor's lives in the
    # port's cli.py (the reference names its own tpukube/cli.py)
    spec = next(s for s in flags.FLAG_REGISTRY if s.flag == "lock_monitor")
    for sfx in spec.construct_scope:
        text = "".join(open(p).read() for p in _port_files(sfx))
        assert "lockgraph.install()" in text, sfx
    assert lockgraph.PACKAGE_SCOPE == PORT_TREE + os.sep


# -- the registries ---------------------------------------------------------------

# every way a registry of the port differs from the reference's, and why
REGISTRY_DIFFERENCES = {
    "flags.FLAG_REGISTRY[lock_monitor].construct_scope":
        "names the port's own CLI, tpukube_torch/cli.py, for the "
        "reference's tpukube/cli.py (a suffix of tpukube/cli.py matches "
        "no file of the port)",
    "lockgraph.PACKAGE_SCOPE":
        "the instrumented package is the port's directory",
}


def _plain(value):
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("module,names", [
    ("base", ("ALL_RULES", "META_RULES", "WAIVABLE_RULES")),
    ("locks", ("DISCIPLINE_SCOPE", "SCHED_LOCKS", "CLASS_DISCIPLINE",
               "BLOCKING_METHODS", "BLOCKING_NAMES", "BLOCKING_QUALIFIED",
               "LOCK_LEVELS", "ORDERED_LOCKS", "CALL_ROOTS", "SELF_METHODS",
               "GUARDED_ATTRS", "EXTERNALLY_LOCKED_ROOTS")),
    ("consistency", ("EMIT_CALLS", "METRIC_CALLS", "DERIVED_SUFFIXES",
                     "SNAPSHOT_HOME", "SWEEP_CONSTRUCTORS", "CYCLE_HOME",
                     "CYCLE_PIN_SEAM", "CYCLE_CACHE_READS",
                     "CYCLE_GRID_BUILDERS", "_REGISTRY_DECLS")),
    ("hygiene", ("LOG_METHODS", "EMIT_METHODS")),
    ("epochs", ("MUTATING_METHODS", "EPOCH_REGISTRY")),
    ("leaks", ("LEAK_REGISTRY",)),
    ("seams", ("TRIPLE_REGISTRY", "REQUIRED_KINDS")),
    ("provenance", ("REFUSAL_REASONS", "REFUSAL_EMITTERS", "RECORD_METHODS",
                    "RECORD_RECEIVERS", "DELEGATES", "SCOPE", "SEAMS")),
    ("cli", ("_RULE_DOCS",)),
])
def test_the_pass_registries_are_the_references(module, names):
    port = importlib.import_module(f"tpukube_torch.analysis.{module}")
    ref = importlib.import_module(f"tpukube.analysis.{module}")
    for name in names:
        assert _plain(getattr(port, name)) == _plain(getattr(ref, name)), name


def test_the_flag_registry_is_the_references_but_the_named_difference():
    got = [dataclasses.asdict(s) for s in flags.FLAG_REGISTRY]
    want = [dataclasses.asdict(s) for s in ref_flags.FLAG_REGISTRY]
    assert "flags.FLAG_REGISTRY[lock_monitor].construct_scope" \
        in REGISTRY_DIFFERENCES
    for g, w in zip(got, want, strict=True):
        if g["flag"] == "lock_monitor":
            assert w["construct_scope"] == ("tpukube/cli.py", "sim/harness.py",
                                            "sched/shardworker.py")
            w["construct_scope"] = ("tpukube_torch/cli.py",
                                    *w["construct_scope"][1:])
        assert g == w
    assert lockgraph.PACKAGE_SCOPE != test_lint.lockgraph.PACKAGE_SCOPE


def test_declared_series_and_reasons_are_the_references():
    from tpukube.obs.events import REASONS as ref_reasons
    from tpukube.obs.registry import DECLARED_SERIES as ref_series
    from tpukube_torch.obs.events import REASONS
    from tpukube_torch.obs.registry import DECLARED_SERIES

    assert DECLARED_SERIES == ref_series and len(DECLARED_SERIES) > 100
    assert REASONS == ref_reasons and len(REASONS) > 20


# -- the rules-file reader ---------------------------------------------------------

HAND_MADE = {
    "every-form": """\
# a leading comment
apiVersion: monitoring.coreos.com/v1
kind: PrometheusRule
metadata:
  name: r   # a trailing comment
  labels:
    app: tpukube
spec:
  groups:
    - name: g.one
      rules:
        # a comment inside a sequence
        - record: tpukube:x:rate5m
          expr: >-
            histogram_quantile(0.99,
              sum(rate(tpukube_webhook_latency_seconds_bucket[5m]))
              by (handler, le))
        - alert: A
          expr: tpukube_replica_up == 0
          for: 2m
          labels:
            severity: page
          annotations:
            summary: a plain summary, with commas; and >= signs
            description: >-
              First line of a folded
              paragraph.

              A second paragraph {{ $labels.tenant }} after a blank line.
    - name: g.two
      rules:
        - record: r2
          expr: >
            sum(rate(tpukube_binds_total[5m]))
""",
    "literal-and-keep": """\
a: |
  line one
    indented two
  line three
b: |-
  stripped
c: >+
  kept

d: 'single ''quoted'''
e: "double \\"quoted\\""
""",
    "indentless-and-scalars": """\
list:
- one
- 2
- true
- key: value
  other: 3
nested:
  empty:
  zero: 0
  neg: -5
  float: 1.5
  word: yes-no
""",
    "two-documents": """\
---
a: 1
---
b:
  - c
""",
}

REFUSED = {
    "flow-sequence": "a: [1, 2]\n",
    "flow-mapping": "a: {b: 1}\n",
    "anchor": "a: &x 1\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "multi-line-plain": "a: one\n  two\n",
    "tab-indent": "a:\n\tb: 1\n",
    "duplicate-key": "a: 1\na: 2\n",
    "complex-key": "? a\n: 1\n",
    "indentation-indicator": "a: >2\n   x\n",
    "over-indented": "a:\n    b: 1\n  c: 2\n",
    "mapping-in-plain": "a: b: c\n",
    "bare-scalar": "just a string\n",
    "directive": "%YAML 1.1\n---\na: 1\n",
    "content-on-document-start": "--- a\n",
    "empty-block-scalar": "a: >-\nb: 1\n",
    "null-value": "a: null\n",
    "bad-middle": "a: 1\nb:\n  - c\n  d: 2\ne: 3\n",
}


@pytest.mark.parametrize("name", ["shipped", "test-lint-fixture",
                                  *sorted(HAND_MADE)])
def test_the_rules_reader_reads_as_pyyaml(name):
    if name == "shipped":
        text = open(RULES_FILE).read()
    elif name == "test-lint-fixture":
        src = inspect.getsource(
            test_lint.test_rules_file_check_catches_unrendered_series)
        start = src.index("bad.write_text(") + len("bad.write_text(")
        text = ast.literal_eval(
            "(" + src[start:src.index("\n    )", start)] + ")")
    else:
        text = HAND_MADE[name]
    got = rulesyaml.load_all(text)
    assert got == list(yaml.safe_load_all(text))
    assert got and got[-1] is not None
    if name in ("shipped", "test-lint-fixture"):
        exprs = [r["expr"] for d in got for g in d["spec"]["groups"]
                 for r in g["rules"]]
        assert len(exprs) >= (20 if name == "shipped" else 1)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_the_rules_reader_refuses_what_it_does_not_read(name, tmp_path):
    with pytest.raises(ValueError):
        rulesyaml.load_all(REFUSED[name])
    bad = tmp_path / "rules.yaml"
    bad.write_text(REFUSED[name])
    with _capsys():
        assert main(["--rules-file", str(bad), str(tmp_path)]) == 2


def test_the_cross_check_reads_every_shipped_expression():
    got = consistency.rule_expressions(RULES_FILE)
    docs = list(yaml.safe_load_all(open(RULES_FILE).read()))
    want = [r.get("expr", "") for d in docs for g in d["spec"]["groups"]
            for r in g["rules"]]
    assert [expr for _, expr in got] == want and len(want) >= 20


def test_lint_cli_runs_with_no_yaml_library():
    # the card machine has no yaml, aiohttp, grpc or protobuf
    blocked = ("yaml", "aiohttp", "grpc", "google.protobuf")
    code = (
        "import json, sys\n"
        "class Refuse:\n"
        f"    blocked = {blocked!r}\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name in self.blocked or name.startswith(tuple(\n"
        "                b + '.' for b in self.blocked)):\n"
        "            raise ImportError(f'{name} is not on this machine')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "for m in list(sys.modules):\n"
        "    if m.split('.')[0] in ('yaml', 'aiohttp', 'grpc'):\n"
        "        del sys.modules[m]\n"
        "from tpukube_torch.analysis.cli import main\n"
        f"rc = main([{PORT_TREE!r}])\n"
        "print(json.dumps({'rc': rc, 'mods': sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {blocked!r} "
        "or m.startswith('google.protobuf'))}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd="/",
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, proc.stderr
    assert lines[-2] == "tpukube-lint: clean"
    assert json.loads(lines[-1]) == {"rc": 0, "mods": []}
