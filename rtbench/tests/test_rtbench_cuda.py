"""The benchmark on the card: every cell once, short, through its command,
and the command refused in a directory that holds only the benchmark.

    python -m pytest -p no:cacheprovider -m cuda rtbench/tests/test_rtbench_cuda.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from rtbench import spec
from rtbench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(cwd, cell: str, seed: int, trace: int):
    return subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload", cell, "--seed",
         str(seed), "--seconds", "2", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda_device):
    proc = _run(ROOT, cell, 2 ** 31 + 99, 0)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["kind"] == __import__("torch").cuda.get_device_name(0)


@pytest.mark.cuda
def test_refused_with_only_the_benchmark(tmp_path, cuda_device):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, CELLS[0], 1, 0)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
