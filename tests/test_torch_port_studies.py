"""The port's studies (``deepwmh_tpu_torch/experiments/studies/``) against
the JAX package's scripts in ``experiments/studies/``: each hands its
workload the JAX script's configuration (the loops stood in by recorders,
so the Tier-1 tests take under a second) and prints parseable JSON with the
JAX script's keys; the fused-stats study runs for real at a toy size on
the CPU. The real loops at toy sizes are ``slow``.
"""

import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest

from deepwmh_tpu_torch.experiments.studies import (
    crossover_e2e_study,
    fused_stats_study,
    seed_variance_study,
    warm_start_study,
)
from deepwmh_tpu_torch.pipeline.multistage import StageBudget
from deepwmh_tpu_torch.unet.plan import Plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_study(name):
    """The JAX package's study script as a module (it runs nothing on import)."""
    path = os.path.join(ROOT, "experiments", "studies", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_study_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_e2e(calls, noisy=False):
    def run_e2e_accuracy(work, **kw):
        calls.append((work, kw))
        if noisy:  # the pipeline's progress lines: the port's study keeps them off stdout
            print("epoch 1/1 loss=0.5", flush=True)
        return {"dice": 0.5, "heldout_dice": {"TEST00": 0.4, "TEST01": 0.6},
                "stage1_dice": {"SUB00": 0.3}, "trainfit_dice": {"SUB00": 0.7}}
    return run_e2e_accuracy


def _run_both(monkeypatch, capsys, name, jax_argv, port_argv):
    """Both scripts with their e2e loop recorded: (JAX's call, the port's
    call, the JAX JSON, the port's JSON)."""
    from deepwmh_tpu.eval import e2e as je2e
    from deepwmh_tpu_torch.eval import e2e

    jcalls, pcalls = [], []
    monkeypatch.setattr(je2e, "run_e2e_accuracy", _fake_e2e(jcalls))
    monkeypatch.setattr(e2e, "run_e2e_accuracy", _fake_e2e(pcalls, noisy=True))
    monkeypatch.setattr(sys, "argv", ["study"] + jax_argv)
    _jax_study(name).main()
    jout = json.loads(capsys.readouterr().out)
    port = {"seed_variance_study": seed_variance_study,
            "crossover_e2e_study": crossover_e2e_study}[name]
    port.main(port_argv + ["--device", "cpu"])
    captured = capsys.readouterr()
    assert "epoch 1/1" in captured.err
    return jcalls[0], pcalls[0], jout, json.loads(captured.out)


def test_seed_variance_study_runs_jaxs_configuration(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (jwork, jkw), (work, kw), jout, out = _run_both(
        monkeypatch, capsys, "seed_variance_study", ["3"], ["3"])
    assert kw.pop("device") == "cpu"
    assert kw == jkw and kw["seed"] == 3 and kw["run_stages"] == "full"
    assert work == os.path.join(str(tmp_path), "seed_study", "3")
    assert jwork.endswith(os.path.join("seed_study", "3"))
    assert set(jout) <= set(out) and out["heldout_dice"] == 0.5 and out["device"] == "cpu"


@pytest.mark.parametrize("mode", ["svf", "learned"])
def test_crossover_study_runs_jaxs_configuration(monkeypatch, capsys, tmp_path, mode):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (jwork, jkw), (work, kw), jout, out = _run_both(
        monkeypatch, capsys, "crossover_e2e_study", [mode], [mode])
    assert kw.pop("device") == "cpu"
    assert kw == jkw and kw["registration_mode"] == mode
    assert work == os.path.join(str(tmp_path), "crossover_study", mode)
    assert set(jout) <= set(out)
    assert out["n_pairs"] == jout["n_pairs"] == 168
    assert out["trainfit_mean_dice"] == 0.7 and out["stage1_mean_dice"] == 0.3
    with pytest.raises(SystemExit):
        crossover_e2e_study.main(["affine"])


def test_warm_start_study_runs_jaxs_schedule(monkeypatch, capsys):
    """The same registrations in the same order (cohorts, preset, warm
    start), the same quality modes, and JAX's keys and projection."""
    from deepwmh_tpu.registration import group as jgroup
    from deepwmh_tpu.registration import quality as jquality
    from deepwmh_tpu_torch.registration import group, quality

    seen = {"jax": [], "port": []}

    def recorder(key):
        class Fake:
            def __init__(self, sources, targets, out, quick=False, large_deformation=False,
                         warm_start=False, device=None):
                seen[key].append(("register", [s for s, _ in sources], [t for t, _ in targets],
                                  os.path.basename(out), quick, large_deformation, warm_start))

            def launch(self, verbose=True):
                time.sleep(0.001)  # the study divides by the walls
        return Fake

    def quality_recorder(key):
        def label_propagation_quality(work, mode="svf", device=None, **kw):
            seen[key].append(("quality", mode, os.path.basename(work)))
            return {"mode": mode, "mean_fg_dice": 0.9}
        return label_propagation_quality

    monkeypatch.setattr(jgroup, "GroupRegistration", recorder("jax"))
    monkeypatch.setattr(group, "GroupRegistration", recorder("port"))
    monkeypatch.setattr(jquality, "label_propagation_quality", quality_recorder("jax"))
    monkeypatch.setattr(quality, "label_propagation_quality", quality_recorder("port"))
    jmod = _jax_study("warm_start_study")
    small = (12, 14, 10)
    monkeypatch.setattr(jmod, "BENCH_SHAPE", small)
    monkeypatch.setattr(warm_start_study, "BENCH_SHAPE", small)
    monkeypatch.setattr(sys, "argv", ["study"])
    jmod.main()
    jout = json.loads(capsys.readouterr().out)
    out = warm_start_study.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 6
    assert set(jout) <= set(out) and set(jout["throughput"]) == set(out["throughput"])
    # the projection from the JAX study's recorded per-pair costs gives its
    # recorded projections
    with open(os.path.join(ROOT, "experiments", "studies", "results",
                           "warm_start_study.json")) as f:
        recorded = json.load(f)["throughput"]
    for key, want in recorded["projected_speedup"].items():
        S, T = map(int, key.split("x"))
        got = warm_start_study.project(S, T, recorded["c_full_s_per_pair"],
                                       recorded["c_warm_s_per_pair"])
        assert round(got, 2) == want, key


def _toy_plan():
    return Plan(target_spacing=[1.0] * 3, patch_size=[16] * 3, batch_size=2,
                pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
                base_features=4, max_features=8)


def test_fused_stats_study_toy_run_on_cpu(monkeypatch, capsys):
    """The whole measurement at a toy size on the CPU (K1's plain versions
    there): the JAX script's keys, both sweeps timed, the two norm paths'
    bf16 probabilities close and their argmax nearly equal."""
    real = fused_stats_study.measure
    monkeypatch.setattr(fused_stats_study, "measure",
                        lambda **kw: real(plan=_toy_plan(), shape=(12, 16, 10), repeats=1, **kw))
    out = fused_stats_study.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    for key in ("sweep", "speedup_median", "speedup_best", "max_abs_prob_diff",
                "argmax_agreement", "device"):
        assert key in out
    assert out["device"] == "cpu" and out["flips"] == 8 and out["padded_shape"] == [12, 16, 12]
    assert set(out["sweep"]) == {"baseline", "fused_stats"}
    # bf16 networks: the two norm paths round at other places
    assert np.isfinite(out["max_abs_prob_diff"]) and out["max_abs_prob_diff"] < 0.05
    assert out["argmax_agreement"] > 0.98


@pytest.mark.slow
def test_seed_variance_study_toy_loop_on_cpu(monkeypatch, capsys, tmp_path):
    """The real loop at a toy size (32x40x32, 2 x 2 pairs, 1 / 1 epoch):
    parseable JSON, a held-out Dice in [0, 1], and a rerun resuming."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(seed_variance_study, "E2E", dict(
        n_ref=2, n_train=2, n_test=1, shape=(32, 40, 32),
        budget=StageBudget(stage2_epochs=1, stage3_epochs=1, batches_per_epoch=2, batch_size=2,
                           voxel_budget=16**3, base_features=4, max_features=8)))
    out = seed_variance_study.main(["5", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["seed"] == 5
    assert 0.0 <= out["heldout_dice"] <= 1.0 and set(out["heldout_per_case"]) == {"TEST00"}
    again = seed_variance_study.main(["5", "--device", "cpu"])
    assert again["heldout_dice"] == out["heldout_dice"] and again["wall_s"] < out["wall_s"]
