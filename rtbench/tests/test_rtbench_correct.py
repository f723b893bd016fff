"""``correct`` at sizes a CPU test holds: sound runs pass, and the
control and every fault that a cell can have come out as not correct.

The runs skip the harness's look for a card (``rtbench.run``) and drive
the rest of a run, ``harness.run_cell``, on the CPU, where the program
runs its plain twins and a chain is a loop of the step. The control and
the faults go through the harness's own judge. A fault is planted in the
program underneath, where it produces its output (each cell's
``faults/<config>.<kind>.py``): a step that returns its state unchanged,
half of the batch left out with the rest scaled up to stand for it, or
an answer altered. No cell spans chips, so none has an exchange between
chips to leave out.
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import harness
from rtbench.tests.conftest import CELLS, small_cell

CPU = torch.device("cpu")
FAULTS = [(name, kind) for name in CELLS
          for kind in small_cell(name).faults()]


def _run(cell, seed: int = 2 ** 31 + 7, substitute=None):
    return harness.run_cell(cell, seed, 0.3, False, CPU,
                            harness.Setup(time.perf_counter()), substitute)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(small_cell(name))
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    check = cell.check()
    for seed in (5, 6, 7):
        out = _run(cell, seed, lambda inputs, got: check.control(
            inputs, cell.config, got, CPU))
        assert not out["correct"], out["numbers"]
        assert out["failed"] > 0


def test_every_cell_has_faults():
    assert {name for name, _ in FAULTS} == set(CELLS)


@pytest.mark.parametrize("name,kind", FAULTS)
def test_fault_is_not_correct(name, kind, monkeypatch):
    cell = small_cell(name)
    cell.faults()[kind](monkeypatch.setattr)
    out = _run(cell)
    assert not out["correct"], (kind, out["numbers"])
    assert out["failed"] > 0
