"""On the card, at each cell's own size: the control (the reference one
precision step down, put in the program's place) and every fault the
cell can have fail the cell's limits, and a sound run passes them.

    python -m pytest -m cuda wmhbench/tests/test_wmhbench_cuda.py -q

Skips without a CUDA card. ``python3 -m wmhbench.readings`` gives the
same readings over many seeds, which the limits were set from."""

from __future__ import annotations

import time

import pytest
import torch

from wmhbench import harness
from wmhbench.run import run_cell

pytestmark = pytest.mark.cuda
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _run(name, seed, device, tmp_path, fault=None):
    return run_cell(harness.load_cell(name), seed, 2.0, False, device, 1,
                    time.perf_counter(), str(tmp_path), fault=fault)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_passes_and_control_fails(name, seed, cuda, tmp_path):
    out, drv = _run(name, seed, cuda, tmp_path)
    assert out["correct"], out["checks"]
    correct, rows = harness.judge(drv.control(), drv.cell.limits)
    assert not correct, rows


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_every_fault_fails(name, seed, cuda, tmp_path):
    cell = harness.load_cell(name)
    for fault in harness.driver_module(cell.driver).Driver.FAULTS:
        (tmp_path / fault).mkdir()
        out, _ = _run(name, seed, cuda, tmp_path / fault, fault=fault)
        assert not out["correct"], (fault, out["checks"])
