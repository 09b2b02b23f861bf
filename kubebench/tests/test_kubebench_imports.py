"""The import check: nothing a run loads, and nothing the reference
loads, is JAX or the JAX package, compared by whole top-level name; the
reference loads nothing of the program either."""

import os
import subprocess
import sys

from kubebench import timeline
from kubebench.manifest import ROOT

BANNED_REF = {"jax", "jaxlib", "flax", "tpukube", "tpukube_torch"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program_or_jax():
    top = _loaded("import kubebench.reference.decoder, kubebench.reference.resnet, "
                  "kubebench.weights, kubebench.compare, kubebench.traffic, kubebench.peaks")
    assert "torch" in top and not top & BANNED_REF


def test_checks_load_nothing_of_the_program():
    code = ("import importlib.util, os\n"
            "for n in ('llama.forward', 'llama.train_step', 'resnet.dp_train_step'):\n"
            "    s = importlib.util.spec_from_file_location('c', os.path.join('kubebench', 'checks', n + '.py'))\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    assert not _loaded(code) & BANNED_REF


def test_run_and_pod_load_no_jax():
    top = _loaded("import kubebench.run, kubebench.pod, kubebench.cluster, tpukube_torch.workload")
    assert "tpukube_torch" in top and not top & {"jax", "jaxlib", "flax", "tpukube"}


def test_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpukube_torch_extra", sys)
    assert "tpukube" not in timeline.banned_modules()
    monkeypatch.setitem(sys.modules, "tpukube.sub", sys)
    assert "tpukube" in timeline.banned_modules()
