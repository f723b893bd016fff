"""Fixtures of the benchmark's tests: its cells cut to sizes a CPU test
can hold, and the card where one is present."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rtbench import spec  # noqa: E402

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name: str) -> spec.Cell:
    """The cell ``name`` of ``BENCHMARK.json`` at the sizes a CPU test
    holds: its configuration's and its traffic's ``small`` keys."""
    cell = spec.Cell(BENCH, name)
    small = cell.config["small"]
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(small["config"])
    cell.config["program"]["bench_config"].update(small["program"])
    cell.traffic = dict(cell.traffic, **cell.traffic["small"])
    return cell


def first_cell(config: str) -> str:
    """The first cell of ``BENCHMARK.json`` that runs ``config``."""
    return next(w["name"] for w in BENCH["workloads"] if w["config"] == config)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
