"""The command as a check runs it: without a card it exits non-zero
and prints no result; in a directory holding only BENCHMARK.json and the
benchmark's folder it does the same."""

import os
import shutil
import subprocess
import sys

from kubebench.manifest import MANIFEST, PKG, ROOT

ARGS = ["-m", "kubebench.run", "--workload", "mistral-7b.prefill-whole",
        "--seed", str(2 ** 32 + 1), "--seconds", "1", "--trace", "0"]


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "kubebench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
