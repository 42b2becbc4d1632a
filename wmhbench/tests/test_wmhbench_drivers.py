"""Each driver's whole run on the CPU at a tiny size, past the harness's
look for a card: the sound program comes out correct, and the control and
every fault the cell can have come out not correct.

The limits here are the tiny cells' own (the cells' limits are set from
readings at their own sizes on the card, ``test_wmhbench_cuda.py``)."""

from __future__ import annotations

import time

import pytest
import torch

from wmhbench import harness
from wmhbench.run import run_cell

SEED = 2**33 + 17
TINY = {
    "train": {
        "config": {"volume_shape": [40, 48, 40], "spacing": [1.0, 1.0, 1.0],
                   "compute_dtype": "bfloat16",
                   "plan": {"target_spacing": [1.0, 1.0, 1.0], "patch_size": [24, 24, 24],
                            "batch_size": 2, "pool_kernels": [[2, 2, 2], [2, 2, 2]],
                            "conv_kernels": [[3, 3, 3]] * 3, "base_features": 4,
                            "max_features": 16, "num_classes": 2, "in_channels": 1,
                            "normalization": "zscore", "median_shape": [40, 48, 40],
                            "pad_style": "same"}},
        "traffic": {"driver": "train", "cases": 2, "label_noise": 0.001, "epochs": 1000,
                    "batches_per_epoch": 4, "oversample_fg": 0.33, "check_steps": 3,
                    "window_check_span": 4, "trace_units": 2},
        "limits": {"grad1_median_leaf_gap": 0.025, "grad1_worst_leaf_gap": 0.5,
                   "change_worst_leaf_gap": 0.5, "window_grad_worst_leaf_gap": 0.5,
                   "window_change_worst_leaf_gap": 0.2},
    },
    "predict": {
        "config": {"volume_shape": [48, 48, 16], "spacing": [0.96, 0.95, 3.0],
                   "compute_dtype": "bfloat16",
                   "plan": {"target_spacing": [0.96, 0.95, 3.0], "patch_size": [28, 28, 16],
                            "batch_size": 2, "pool_kernels": [[2, 2, 1], [2, 2, 2], [1, 1, 2]],
                            "conv_kernels": [[3, 3, 1], [3, 3, 3], [3, 3, 3], [3, 3, 1]],
                            "base_features": 4, "max_features": 16, "num_classes": 2,
                            "in_channels": 1, "normalization": "zscore",
                            "median_shape": [48, 48, 16], "pad_style": "same"}},
        "traffic": {"driver": "predict", "pool": 2, "n4": True, "previews": True,
                    "check_cases": 2, "trace_units": 1},
        "limits": {"n4_rel_max": 3e-4, "raw_decisive_per_near": 0.02,
                   "post_3mm_decisive_per_near": 0.03, "post_fov_decisive_per_near": 0.02},
    },
    "stage1": {
        "config": {"volume_shape": [40, 48, 36], "spacing": [1.0, 1.0, 1.0],
                   "compute_dtype": "float32", "plan": {}},
        "traffic": {"driver": "stage1", "K": 3, "check_cases": 2, "trace_units": 1},
        "limits": {"anomaly_rel_max": 1e-3, "threshold_rel": 1e-3, "masks_mismatch": 1e-4},
    },
}


def tiny_cell(driver: str) -> harness.Cell:
    spec = harness.benchmark_spec()
    real = next(w["name"] for w in spec["workloads"]
                if harness.load_cell(w["name"], spec).driver == driver)
    like = harness.load_cell(real, spec)
    t = TINY[driver]
    return harness.Cell(driver + ".tiny", t["config"], t["traffic"], t["limits"],
                        like.end_to_end, like.per_layer)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(driver, tmp_path, fault=None, trace=False, seconds=1.0):
    return run_cell(tiny_cell(driver), SEED, seconds, trace, torch.device("cpu"), 1,
                    time.perf_counter(), str(tmp_path), fault=fault)


@pytest.mark.parametrize("driver", sorted(TINY))
def test_sound_run_is_correct_and_reports_its_metrics(driver, tmp_path):
    out, drv = _run(driver, tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= out["units"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in drv.cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    # the control, put in the program's place, fails the same limits
    correct, rows = harness.judge(drv.control(), drv.cell.limits)
    assert not correct, rows


@pytest.mark.parametrize("driver,fault", [("train", "half_batch"),
                                          ("train", "state_unchanged"),
                                          ("train", "window_state_unchanged"),
                                          ("predict", "answer_altered"),
                                          ("stage1", "answer_altered")])
def test_planted_fault_is_not_correct(driver, fault, tmp_path):
    out, _ = _run(driver, tmp_path, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("driver", sorted(TINY))
def test_traced_run_reads_the_window(driver, tmp_path):
    out, drv = _run(driver, tmp_path, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    # a CPU trace has no device kernels: only the host-clock metrics read
    assert set(out["metrics"]) == {m["name"] for m in drv.cell.per_layer
                                   if m["source"] == "host_clock"}


def test_a_fault_that_starts_in_the_window_fails_only_the_window_step(tmp_path):
    """The steps checked in set-up cannot see a path that changes once the
    step is warm; the window's checked step does."""
    out, _ = _run("train", tmp_path, fault="window_state_unchanged")
    failing = {name for name, v, limit in out["checks"] if not v <= limit}
    assert failing and all(name.startswith("window_") for name in failing), out["checks"]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_inputs_read_back_as_written(dtype, tmp_path):
    """What set-up writes (float32 volumes; uint8 label maps) the port's
    reader and the benchmark's own read back as the same float32 values."""
    import numpy as np

    from deepwmh_tpu_torch.core import nifti
    from wmhbench.niftiio import read_nifti, write_nifti

    vol = np.random.default_rng(3).integers(0, 4, (12, 14, 10)).astype(np.float32)
    path = str(tmp_path / "v.nii")
    write_nifti(path, vol, (0.96, 0.95, 3.0), dtype=np.dtype(dtype), sync=True)
    assert np.array_equal(nifti.load_nifti_simple(path), vol)
    assert np.array_equal(read_nifti(path), vol)
    assert nifti.get_nifti_pixdim(path) == pytest.approx([0.96, 0.95, 3.0])
