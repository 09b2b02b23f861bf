"""The port's CFG dataflow engine and the passes on it
(``tpukube_torch/analysis/cfg.py``, ``callgraph.py``, ``epochs.py``,
``leaks.py``, ``seams.py``) held against the reference's.

Twins (``run_port``: each reference test's body on the port):
test_cfg.py's tests but those named in ``CFG_SKIPS``, which lint the
reference's own ``sched/`` modules by path; each has a stand-in below
that lints the port's module of the same name, the mutation sweeps
deleting every bump and note of the port's ``sched/state.py`` and
``sched/gang.py`` one at a time."""

import ast
import importlib
import os

import pytest

import test_cfg
from tpukube_torch.analysis import base, cfg
from tpukube_torch.analysis.epochs import check_epochs
from tpukube_torch.analysis.seams import check_seam_triples
from torch_twin import TMP_PATH, reference_tests, run_port

for _name in ("base", "callgraph", "cfg", "epochs", "leaks", "seams"):
    importlib.import_module(f"tpukube.analysis.{_name}")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = os.path.join(REPO, "tpukube_torch")

_PATH = ("lints the reference's tpukube/{} by path; {} lints the port's")
CFG_SKIPS = {
    "test_snapshot_cache_mutation_kill": _PATH.format(
        "sched/snapshot.py", "test_snapshot_cache_mutation_kill_on_the_port"),
    "test_seam_triple_mutation_kill_sweep": _PATH.format(
        "sched/state.py and sched/gang.py",
        "test_seam_triple_mutation_kill_sweep_on_the_port"),
    "test_real_tree_clean_under_both_passes": _PATH.format(
        "tree", "test_real_tree_clean_under_both_passes_on_the_port"),
    "test_mutation_kill_every_epoch_bump_is_covered": _PATH.format(
        "sched/state.py and sched/gang.py",
        "test_mutation_kill_every_epoch_bump_is_covered_on_the_port"),
}


@pytest.mark.parametrize("fn", reference_tests(test_cfg, CFG_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_cfg_tests_hold_on_the_port(fn):
    run_port(fn, TMP_PATH)


def _killed(rel: str, lines: list, lo: int, hi: int, check) -> list:
    """The findings of ``check`` over the port's ``rel`` with lines lo..hi
    (1-based) replaced by ``pass``, the real waivers applied."""
    mutated = list(lines)
    indent = len(lines[lo - 1]) - len(lines[lo - 1].lstrip())
    mutated[lo - 1] = " " * indent + "pass\n"
    for i in range(lo, hi):
        mutated[i] = "\n"
    sf = base.SourceFile(os.path.join(PORT_TREE, rel), text="".join(mutated),
                         rel=rel)
    return base.apply_waivers(sf, check(sf))


def test_snapshot_cache_mutation_kill_on_the_port():
    lines = open(os.path.join(PORT_TREE, "sched", "snapshot.py")).read() \
        .splitlines(keepends=True)
    bumps = [i + 1 for i, ln in enumerate(lines)
             if ln.strip() == "self._snap_gen += 1"]
    assert bumps, "snapshot.py: no _snap_gen bumps found?"
    for n in bumps:
        assert _killed("sched/snapshot.py", lines, n, n, check_epochs), (
            f"sched/snapshot.py:{n}: deleting this _snap_gen bump went "
            f"UNDETECTED")


def test_seam_triple_mutation_kill_sweep_on_the_port():
    # test_cfg.py's sweep over the port's ledger and gang modules: every
    # single delta note, journal note and epoch bump deleted is caught
    survivors = []
    total = 0
    for rel in ("sched/state.py", "sched/gang.py"):
        src = open(os.path.join(PORT_TREE, rel)).read()
        lines = src.splitlines(keepends=True)
        mutants = test_cfg._seam_mutants(src)
        assert len(mutants) >= 20, f"{rel}: seam sites went missing?"
        total += len(mutants)
        for what, lo, hi in mutants:
            if not _killed(rel, lines, lo, hi, lambda sf: (
                    check_seam_triples(sf) + check_epochs(sf))):
                survivors.append(f"{rel}:{lo} ({what})")
    assert total >= 80
    assert not survivors, (
        "deleting these seam sites went UNDETECTED: " + ", ".join(survivors))


def test_real_tree_clean_under_both_passes_on_the_port():
    findings = base.run_all(
        [PORT_TREE], rules=["epoch-discipline", "reservation-leak"])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_mutation_kill_every_epoch_bump_is_covered_on_the_port():
    for rel in ("sched/state.py", "sched/gang.py"):
        lines = open(os.path.join(PORT_TREE, rel)).read() \
            .splitlines(keepends=True)
        bumps = [i + 1 for i, ln in enumerate(lines)
                 if ln.strip() == "self._epoch += 1"]
        assert bumps, f"{rel}: no epoch bumps found?"
        for n in bumps:
            assert _killed(rel, lines, n, n, check_epochs), (
                f"{rel}:{n}: deleting this epoch bump went UNDETECTED — the "
                f"seam it guards is not covered by analysis/epochs.py "
                f"EPOCH_REGISTRY")


def test_the_port_has_the_references_seam_sites():
    # the port's ledger and gang modules carry as many bumps and notes as
    # the reference's, kind for kind (the sweeps above then cover each)
    for rel in ("sched/state.py", "sched/gang.py"):
        def kinds(root):
            src = open(os.path.join(REPO, root, rel)).read()
            return sorted(what for what, _, _ in test_cfg._seam_mutants(src))
        assert kinds("tpukube_torch") == kinds("tpukube"), rel
    assert isinstance(cfg.build_cfg(ast.parse("def f(): pass").body[0]),
                      cfg.FunctionCFG)
