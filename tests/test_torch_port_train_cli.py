"""deepwmh_tpu_torch's ``DeepWMH_train`` end to end on the CPU: one whole
``run_train`` on ``tests/test_train_pipeline_e2e.py``'s cohort (24x24x20
at 2 mm, 2 references, 2 patients, N4 skipped, 2/2 epochs x 2 batches at a
16^3 budget, base 4 / max 8): the nine markers, the registration artifacts,
stage-1 recall > 0.9 and Dice > 0.15 against the planted lesion (the JAX
test's floors), the release, the seconds of each step and stage in
``stage_stats``, a resume under 60 s; across packages, the
port's release loads in JAX's ``load_released_model`` and JAX's pipeline
finds every marker in the port's core folder and trains nothing. The CLI
resumes it over a (CPU) mesh with ``--mesh`` and refuses to run without a
card unless asked for the CPU. ``run_e2e_accuracy`` and ``label_propagation_quality``
run as the JAX package's slow tests do; a slow witness runs both packages'
``run_train`` up to stage I on one e2e-sized cohort.
"""

import os
import shutil
import time

import numpy as np
import pytest

import torch

from deepwmh_tpu.pipeline import multistage as jms
from deepwmh_tpu.unet.release import load_released_model as jload_released_model
from deepwmh_tpu_torch.cli import install_model as install_cli
from deepwmh_tpu_torch.cli import train
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.pipeline.multistage import StageBudget
from torch_port_cohort import BUDGET, MARKERS, write_e2e_cohort

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    ref_csv, tr_csv, lesions = write_e2e_cohort(root)
    out = os.path.join(root, "out")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)  # tiny products; the test workers share the cores
    stats = {}
    try:
        core = train.run_train(ref_csv, tr_csv, out, skip_bfc=True,
                               budget=StageBudget(**BUDGET), device="cpu", stage_stats=stats)
    finally:
        torch.set_num_threads(saved)
    return {"root": root, "ref_csv": ref_csv, "tr_csv": tr_csv, "lesions": lesions,
            "out": out, "core": core, "stage_stats": stats}


def _weights(core):
    """mtime of every checkpoint file under the core folder."""
    return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
            for d, _, fs in os.walk(core) for f in fs if f.endswith(".msgpack")}


def test_run_train_sets_every_marker_and_releases(trained):
    out, core = trained["out"], trained["core"]
    assert core == os.path.join(out, "004_WMH_pipeline")
    for m in MARKERS:
        assert os.path.isfile(os.path.join(core, "Checkpoints", m)), m
    assert nifti.try_load_nifti(os.path.join(out, "002_Registration", "REF0_to_SUB0.nii.gz"))
    assert nifti.try_load_nifti(os.path.join(out, "003_Transformed", "REF1_to_SUB1",
                                             "label1.nii.gz"))
    with open(os.path.join(out, "run_registration.sh")) as f:
        script = f.read()
    assert "python -m deepwmh_tpu_torch.cli.group_register" in script
    assert "--allow-quick-registration --allow-large-deformations" in script
    for name in ("regsource.csv", "regtarget.csv"):
        assert os.path.isfile(os.path.join(out, name))
    assert nifti.try_load_nifti(os.path.join(
        core, "Stage_2_label_denoising", "005_refined_label", "SUB0", "label_ensembled.nii.gz"))
    assert os.path.isfile(os.path.join(core, "Stage_3_DCNN_training", "001_data_partitions",
                                       "split.json"))
    assert os.path.isfile(os.path.join(core, "Model_release", "model_release.tar.gz"))


def test_run_train_records_each_step(trained):
    """stage_stats holds the seconds of run_train's own steps and of every
    pipeline stage and the release (no peak memory on the CPU)."""
    stats = trained["stage_stats"]
    assert list(stats) == ["n4", "registration", "label_propagation", "stage1", "2-2_dataset",
                           "2-3_training", "2-4_raw_softmax", "2-5_masked_softmax",
                           "2-6_ensembling", "3-3_dataset", "3-4_training", "3-5_final_fit",
                           "release"]
    assert all(set(st) == {"s"} and st["s"] >= 0.0 for st in stats.values()), stats
    assert stats["registration"]["s"] > stats["label_propagation"]["s"]


def test_stage1_detects_the_lesion(trained):
    seg = nifti.load_nifti_simple(os.path.join(
        trained["core"], "Stage_1_initial_segmentation", "SUB0", "segmentation_pp.nii.gz"))
    les = trained["lesions"]["SUB0"]
    inter = ((seg > 0.5) & (les > 0.5)).sum()
    recall = inter / max((les > 0.5).sum(), 1)
    dice = 2 * inter / max((seg > 0.5).sum() + (les > 0.5).sum(), 1)
    assert recall > 0.9, "stage-1 recall too low: %.3f" % recall
    assert dice > 0.15, "stage-1 dice too low: %.3f" % dice


def test_resume_is_cheap_and_trains_nothing(trained):
    before = _weights(trained["core"])
    t0 = time.time()
    train.run_train(trained["ref_csv"], trained["tr_csv"], trained["out"], skip_bfc=True,
                    budget=StageBudget(**BUDGET), device="cpu")
    assert time.time() - t0 < 60
    assert _weights(trained["core"]) == before


def test_release_installs_and_loads_in_jax(trained, tmp_path, capsys):
    """The install CLI unpacks the port's release (and refuses a non-empty
    folder without -f); JAX's load_released_model reads it."""
    tarball = os.path.join(trained["core"], "Model_release", "model_release.tar.gz")
    dest = str(tmp_path / "model")
    install_cli.main(["-m", tarball, "-o", dest])
    with pytest.raises(SystemExit, match="empty directory"):
        install_cli.main(["-m", tarball, "-o", dest])
    install_cli.main(["-i", tarball, "-o", dest, "-f"])
    _, params, plan = jload_released_model(dest)
    assert plan.base_features == 4 and plan.max_features == 8
    assert "seg_head_0" in params


def test_jax_pipeline_resumes_the_ports_core(trained):
    """JAX's pipeline on the port's core folder: every marker found, no
    checkpoint written."""
    core = trained["core"]
    before = _weights(core)
    p = jms.PipelineMultistage(core, budget=jms.StageBudget(**BUDGET))
    for c in ("SUB0", "SUB1"):
        p.add_training_case(c, "unused", [], [], [])
    p.run_training("full")
    for m in MARKERS:
        assert p.checkpoints.is_finished(m), m
    assert _weights(core) == before


def test_cli_mesh_exits_naming_a13(trained, monkeypatch, capsys):
    """The name is the refusal's this test replaced: --mesh now runs. With
    make_mesh stood in by a 2-shard CPU mesh the CLI resumes the trained
    folder over the mesh and trains nothing; --mesh with --device exits."""
    from deepwmh_tpu_torch.parallel.mesh import Mesh

    argv = ["-s", trained["ref_csv"], "-t", trained["tr_csv"], "-o", trained["out"],
            "--skip-bfc", "--skip-integrity-check"] + sum(
        (["--" + k.replace("_", "-"), str(BUDGET[k])] for k in
         ("stage2_epochs", "stage3_epochs", "batches_per_epoch", "batch_size")), [])
    with pytest.raises(SystemExit):
        train.main(argv + ["--mesh", "--device", "cpu"])
    monkeypatch.setattr(train, "make_mesh", lambda: Mesh(["cpu"] * 2))
    before = _weights(trained["core"])
    capsys.readouterr()
    train.main(argv + ["--mesh"])
    said = capsys.readouterr().out
    assert "mesh: 2 device(s) (cpu)" in said and "epoch " not in said
    assert _weights(trained["core"]) == before


def test_cli_refuses_to_run_without_a_card(trained, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = os.path.join(trained["root"], "cli")
    with pytest.raises(SystemExit) as err:
        train.main(["-s", trained["ref_csv"], "-t", trained["tr_csv"], "-o", out])
    assert err.value.code == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not os.path.exists(out)


@pytest.mark.slow
def test_e2e_heldout_dice_floor(tmp_path):
    """tests/test_e2e_accuracy.py's configuration and floors on the port."""
    from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy

    budget = StageBudget(stage2_epochs=6, stage3_epochs=14, batches_per_epoch=12,
                         batch_size=2, voxel_budget=24**3, base_features=16,
                         max_features=128)
    res = run_e2e_accuracy(str(tmp_path), shape=(48, 56, 48), n_ref=4, n_train=2,
                           n_test=1, budget=budget, run_stages="full", device="cpu")
    assert min(res["stage1_dice"].values()) > 0.3, res["stage1_dice"]
    assert res["dice"] >= 0.70, res
    for case, (_, r) in res["heldout_pr"].items():
        assert r >= 0.80, (case, r)
    assert float(np.mean(list(res["trainfit_dice"].values()))) >= 0.70, res


@pytest.mark.slow
@pytest.mark.parametrize("mode,floor", [("svf", 0.75), ("learned", 0.72)])
def test_label_propagation_quality_floor(tmp_path, mode, floor):
    """tests/test_registration_quality.py's configuration and floors on the
    port: two distinct phantom anatomies through the group registration."""
    from deepwmh_tpu_torch.registration.learned import LearnedRegConfig
    from deepwmh_tpu_torch.registration.quality import label_propagation_quality

    cfg = LearnedRegConfig(steps=120) if mode == "learned" else None
    q = label_propagation_quality(str(tmp_path), mode=mode, shape=(32, 40, 32),
                                  learned_cfg=cfg, device="cpu")
    assert q["unregistered_dice"] < 0.75, q
    assert q["mean_fg_dice"] >= floor, q
    assert q["mean_fg_dice"] > q["unregistered_dice"] + 0.10, q
    assert q["brain_dice"] > 0.9, q


@pytest.mark.slow
@pytest.mark.parametrize("seed,n_ref,n_train", [(2, 5, 3), (0, 3, 3)])
def test_stage1_witness_against_jax(tmp_path, seed, n_ref, n_train):
    """Both packages' run_train up to stage I on one phantom cohort at
    64x80x64 2 mm (N4 skipped, svf): the e2e accuracy configuration's 5
    references x 3 patients at seed 2, and chip_smoke's train_e2e cohort
    (3 x 3, seed 0). Each package's stage-1 Dice against the lesion GT
    (the JAX test's floors), its propagated tissue labels against each
    patient's own (the phantom's label2), and the two packages' propagated
    labels against each other. The port's stage-1 Dice must be within 0.1
    of JAX's and its mean propagated tissue Dice within 0.05. Prints the
    readings as one JSON line."""
    import json

    from deepwmh_tpu.cli.train import run_train as jrun_train
    from deepwmh_tpu_torch.eval.metrics import hard_dice_binary
    from deepwmh_tpu_torch.eval.phantom import make_subject, write_cohort

    shape = (64, 80, 64)
    ref_csv, tr_csv, gt_paths = write_cohort(str(tmp_path / "data"), shape=shape, n_ref=n_ref,
                                             n_train=n_train, seed=seed, device="cpu")
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jrun_train(ref_csv, tr_csv, outs["jax"], skip_bfc=True, run_stages="initseg",
               registration_mode="svf")
    train.run_train(ref_csv, tr_csv, outs["port"], skip_bfc=True, run_stages="initseg",
                    registration_mode="svf", device="cpu")

    def tissue_dice(a, b):
        return float(np.mean([hard_dice_binary(a == c, b == c) for c in (1, 2, 3)]))

    read = {"stage1_dice": {}, "propagated_tissue_dice": {}}
    refs, subs = ["REF%02d" % i for i in range(n_ref)], ["SUB%02d" % i for i in range(n_train)]
    truth = {s: make_subject(shape, seed + 1000 + i, lesion=True, device="cpu")["label2"]
             for i, s in enumerate(subs)}
    between = []
    for pkg, out in outs.items():
        read["stage1_dice"][pkg] = {s: hard_dice_binary(nifti.load_nifti_simple(os.path.join(
            out, "004_WMH_pipeline", "Stage_1_initial_segmentation", s,
            "segmentation_pp.nii.gz")), nifti.load_nifti_simple(gt_paths[s])) for s in subs}
        read["propagated_tissue_dice"][pkg] = {}
        for r in refs:
            for s in subs:
                lab = nifti.load_nifti_simple(os.path.join(
                    out, "003_Transformed", "%s_to_%s" % (r, s), "label2.nii.gz"))
                read["propagated_tissue_dice"][pkg]["%s_to_%s" % (r, s)] = tissue_dice(
                    lab, truth[s])
    for r in refs:
        for s in subs:
            j, p = (nifti.load_nifti_simple(os.path.join(
                outs[k], "003_Transformed", "%s_to_%s" % (r, s), "label2.nii.gz"))
                for k in ("jax", "port"))
            between.append(tissue_dice(j, p))
    means = {key: {pkg: float(np.mean(list(v.values()))) for pkg, v in read[key].items()}
             for key in read}
    print(json.dumps({"witness": "stage1", "seed": seed, "pairs": [n_ref, n_train],
                      "means": means, "port_vs_jax_tissue_dice":
                      float(np.mean(between)), **read}))
    for pkg in outs:
        assert min(read["stage1_dice"][pkg].values()) > 0.15, read["stage1_dice"]
    assert abs(means["stage1_dice"]["port"] - means["stage1_dice"]["jax"]) < 0.1, means
    assert abs(means["propagated_tissue_dice"]["port"]
               - means["propagated_tissue_dice"]["jax"]) < 0.05, means


# the configuration of test_e2e_heldout_dice_floor (tests/test_e2e_accuracy.py's)
WITNESS_E2E = dict(shape=(48, 56, 48), n_ref=4, n_train=2, n_test=1)
WITNESS_BUDGET = dict(stage2_epochs=6, stage3_epochs=14, batches_per_epoch=12, batch_size=2,
                      voxel_budget=24**3, base_features=16, max_features=128)
WITNESS_MARKERS = ("STAGE_2-4_RAW_SOFTMAX", "STAGE_2-5_MASKED_SOFTMAX", "STAGE_2-6_ENSEMBLING",
                   "STAGE_3-1_DATA_SPLIT", "STAGE_3-5_FINAL_FIT", "PIPELINE_TRAINING_COMPLETE")


def _first_parting(a, b, rtol=1e-3):
    """The first (1-based) epoch whose readings part by more than ``rtol``,
    or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if abs(x - y) > rtol * max(abs(x), abs(y), 1e-12):
            return i + 1
    return None


def _cut_copy(src, dst, markers, paths):
    """A copy of a finished e2e work folder with ``markers`` cleared and the
    artifacts under ``paths`` (relative to the pipeline's core folder)
    removed, so a resume redoes exactly those phases."""
    shutil.copytree(src, dst)
    core = os.path.join(dst, "train_out", "004_WMH_pipeline")
    for m in markers:
        os.remove(os.path.join(core, "Checkpoints", m))
    for rel in paths + ("Model_release",):
        shutil.rmtree(os.path.join(core, rel), ignore_errors=True)
    for rel in ("installed_model", "predict_out"):
        shutil.rmtree(os.path.join(dst, rel), ignore_errors=True)
    return core


@pytest.mark.slow
def test_stage2_witness_against_jax(tmp_path, monkeypatch):
    """Fault C5's witness: where the packages part after stage I. JAX runs
    the e2e floor's configuration (48x56x48, 4 x 2 pairs, base 16 -> 128)
    through stage I; the port's stages II-III then start from JAX's stage-I
    artifacts (the shared artifact contract), both packages training in
    f32 without augmentation, the port from JAX's initial weights of each
    stage (``Trainer.init_state`` monkeypatched; torch on one thread).

    Compared: the per-epoch training losses of stage II and (from JAX's
    stage-II outputs) stage III and stage III's validation metric, each
    with the first epoch where they part by more than rtol 1e-3 (reported;
    training amplifies last-bit differences); then the deterministic
    pieces, each redone by the port on JAX's own inputs in a cut copy of
    JAX's finished folder: the 2-4 sweep on JAX's ensemble checkpoints (fg
    within 1e-3), 2-5 / 2-6 (> 99.9% voxel agreement), stage III's split
    (equal), the 3-5 fit on JAX's model (> 99.9%); and the held-out Dice of
    each package's model. Prints the readings as one JSON line. JAX keeps
    its own XLA thread settings (set XLA_FLAGS before the run to pin it)."""
    import functools
    import json

    import jax

    from deepwmh_tpu.eval import e2e as je2e
    from deepwmh_tpu.pipeline.multistage import StageBudget as JStageBudget
    from deepwmh_tpu.unet import checkpoint as jckpt
    from deepwmh_tpu.unet import train as jtrain
    from deepwmh_tpu_torch.eval import e2e
    from deepwmh_tpu_torch.pipeline import multistage as ms
    from deepwmh_tpu_torch.unet import checkpoint as ckpt
    from deepwmh_tpu_torch.unet import train as ptrain

    torch.set_num_threads(1)
    jwork, pwork = str(tmp_path / "jax"), str(tmp_path / "port")
    je2e.run_e2e_accuracy(jwork, budget=JStageBudget(**WITNESS_BUDGET), run_stages="initseg",
                          **WITNESS_E2E)
    shutil.copytree(jwork, pwork)

    # both packages: f32 networks, no augmentation; each checkpoint's meta
    # and JAX's initial weights of each stage recorded
    monkeypatch.setattr(jms, "TrainConfig", functools.partial(jtrain.TrainConfig, augment=False))
    monkeypatch.setattr(jtrain, "UNet3D", functools.partial(jtrain.UNet3D,
                                                            dtype=jax.numpy.float32))
    monkeypatch.setattr(jms, "UNet3D", functools.partial(jms.UNet3D, dtype=jax.numpy.float32))
    monkeypatch.setattr(ms, "TrainConfig", functools.partial(ptrain.TrainConfig, augment=False))
    monkeypatch.setattr(ms, "Trainer", functools.partial(ptrain.Trainer, dtype=torch.float32))
    monkeypatch.setattr(ms, "UNet3D", functools.partial(ms.UNet3D, dtype=torch.float32))
    inits, metas = {}, {"jax": {}, "port": {}}

    def task_of(out_dir):
        return os.path.basename(os.path.dirname(os.path.abspath(out_dir)))

    run = {"jax": "jax", "port": "port"}  # whose readings the next run records

    def recording(save, package):
        def wrapped(out_dir, name, *a, **kw):
            if name == "model_latest":
                metas.setdefault(run[package], {}).setdefault(task_of(out_dir), []).append(
                    dict(a[-1] if a else kw["meta"]))
            return save(out_dir, name, *a, **kw)
        return wrapped

    monkeypatch.setattr(jckpt, "save_checkpoint", recording(jckpt.save_checkpoint, "jax"))
    monkeypatch.setattr(ckpt, "save_checkpoint", recording(ckpt.save_checkpoint, "port"))
    jinit = jtrain.Trainer.init_state

    def jax_init(self, rng):
        params, opt_state = jinit(self, rng)
        inits[task_of(self.out_dir)] = jax.device_get(params)
        return params, opt_state

    def from_jax_init(self, seed):
        self.load_state_trees(inits[task_of(self.out_dir)])
        for t in self.trace:
            t.zero_()

    monkeypatch.setattr(jtrain.Trainer, "init_state", jax_init)
    monkeypatch.setattr(ptrain.Trainer, "init_state", from_jax_init)

    budget = StageBudget(**WITNESS_BUDGET)
    res = {"jax": je2e.run_e2e_accuracy(jwork, budget=JStageBudget(**WITNESS_BUDGET),
                                        run_stages="full", **WITNESS_E2E)}
    res["port"] = e2e.run_e2e_accuracy(pwork, budget=budget, run_stages="full", device="cpu",
                                       **WITNESS_E2E)

    # stage III given JAX's stage II: the port trains stage III only
    p3work = str(tmp_path / "port_stage3")
    _cut_copy(jwork, p3work, ("STAGE_3-4_TRAINING", "STAGE_3-5_FINAL_FIT",
                              "PIPELINE_TRAINING_COMPLETE"),
              ("DCNN_Outputs/Task002_FinalModel/training", "Stage_3_DCNN_training/002_training_fit"))
    run["port"] = "port_stage3"
    res["port_stage3"] = e2e.run_e2e_accuracy(p3work, budget=budget, run_stages="full",
                                              device="cpu", **WITNESS_E2E)

    # the deterministic pieces on JAX's inputs: 2-4 on JAX's checkpoints,
    # 2-5, 2-6, the split and the 3-5 fit on JAX's model
    cut = str(tmp_path / "port_cut")
    core_cut = _cut_copy(jwork, cut, WITNESS_MARKERS, (
        "Stage_2_label_denoising/003_raw_softmax", "Stage_2_label_denoising/004_masked_softmax",
        "Stage_2_label_denoising/005_refined_label", "Stage_3_DCNN_training/001_data_partitions",
        "Stage_3_DCNN_training/002_training_fit"))
    res["port_cut"] = e2e.run_e2e_accuracy(cut, budget=budget, run_stages="full", device="cpu",
                                           **WITNESS_E2E)
    core_jax = os.path.join(jwork, "train_out", "004_WMH_pipeline")

    def load(core, *rel):
        return nifti.load_nifti_simple(os.path.join(core, *rel))

    subs = ["SUB%02d" % i for i in range(WITNESS_E2E["n_train"])]
    s2 = "Stage_2_label_denoising"
    epochs = range(WITNESS_BUDGET["stage2_epochs"] - max(int(0.1 * WITNESS_BUDGET[
        "stage2_epochs"]), 1) + 1, WITNESS_BUDGET["stage2_epochs"] + 1)
    fg_diff = max(float(np.abs(load(core_cut, s2, "003_raw_softmax", "epoch_%04d" % e,
                                    "%s_0.nii.gz" % c)
                               - load(core_jax, s2, "003_raw_softmax", "epoch_%04d" % e,
                                      "%s_0.nii.gz" % c)).max())
                  for e in epochs for c in subs)
    masked = min(float((np.abs(load(core_cut, s2, "004_masked_softmax", "epoch_%04d" % e,
                                    "%s_0.nii.gz" % c)
                               - load(core_jax, s2, "004_masked_softmax", "epoch_%04d" % e,
                                      "%s_0.nii.gz" % c)) <= 1e-3).mean())
                 for e in epochs for c in subs)
    refined = min(float((load(core_cut, s2, "005_refined_label", c, "label_ensembled.nii.gz")
                         == load(core_jax, s2, "005_refined_label", c,
                                 "label_ensembled.nii.gz")).mean()) for c in subs)
    split = {k: json.load(open(os.path.join(core, "Stage_3_DCNN_training",
                                            "001_data_partitions", "split.json")))
             for k, core in (("port", core_cut), ("jax", core_jax))}
    fit = min(float((load(core_cut, "Stage_3_DCNN_training", "002_training_fit",
                          "3mm_postproc", "%s.nii.gz" % c)
                     == load(core_jax, "Stage_3_DCNN_training", "002_training_fit",
                             "3mm_postproc", "%s.nii.gz" % c)).mean()) for c in subs)

    def losses(package, task, key="train_loss"):
        return [m[key] for m in metas[package].get(task, [])]

    t2, t3 = ms.PipelineMultistage.STAGE2_TASK, ms.PipelineMultistage.STAGE3_TASK
    readings = {
        "stage2_loss": {"jax": losses("jax", t2), "port": losses("port", t2)},
        "stage3_loss_from_jax_stage2": {"jax": losses("jax", t3),
                                        "port": losses("port_stage3", t3)},
        "stage3_val_from_jax_stage2": {"jax": losses("jax", t3, "val_metric"),
                                       "port": losses("port_stage3", t3, "val_metric")},
        "cut": {"fg_2_4_max_abs": fg_diff, "masked_2_5_within_1e-3": masked,
                "label_2_6_agreement": refined, "split": split, "fit_3_5_agreement": fit},
        "heldout_dice": {k: r["dice"] for k, r in res.items()},
        "stage1_dice": {k: r["stage1_dice"] for k, r in res.items()},
        "trainfit_dice": {k: r["trainfit_dice"] for k, r in res.items()},
    }
    readings["first_parting_epoch"] = {
        k: _first_parting(readings[k]["jax"], readings[k]["port"])
        for k in ("stage2_loss", "stage3_loss_from_jax_stage2", "stage3_val_from_jax_stage2")}
    print("\n" + json.dumps({"witness": "stage2", **readings}))
    assert len(readings["stage2_loss"]["port"]) == WITNESS_BUDGET["stage2_epochs"]
    assert len(readings["stage3_loss_from_jax_stage2"]["port"]) == WITNESS_BUDGET["stage3_epochs"]
    # the deterministic pieces: a disagreement here is a port defect
    assert fg_diff <= 1e-3, readings["cut"]
    assert masked > 0.999 and refined > 0.999, readings["cut"]
    assert split["port"] == split["jax"], split
    assert fit > 0.999, readings["cut"]


@pytest.mark.slow
@pytest.mark.parametrize("train_seed", [0, 1, 2])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_training_seed_spread(tmp_path, monkeypatch, package, train_seed):
    """Fault C5's spread: test_e2e_heldout_dice_floor's loop (cohort seed 0,
    48x56x48, 4 x 2 pairs, base 16 -> 128) with the training seed
    (``TrainConfig.seed``: initial weights, augmentation draws and patch
    sampling) set to ``train_seed`` in the pipeline of ``package``. Prints
    the held-out, stage-1 and training-fit Dice as one JSON line. The
    threads are the run's own (torch's from OMP_NUM_THREADS, JAX's from
    XLA_FLAGS): launch it once per setting to compare them."""
    import functools
    import json

    if package == "jax":
        from deepwmh_tpu.eval.e2e import run_e2e_accuracy
        from deepwmh_tpu.pipeline.multistage import StageBudget as Budget
        from deepwmh_tpu.unet.train import TrainConfig

        monkeypatch.setattr(jms, "TrainConfig", functools.partial(TrainConfig, seed=train_seed))
        kw = {}
    else:
        from deepwmh_tpu_torch.eval.e2e import run_e2e_accuracy
        from deepwmh_tpu_torch.pipeline import multistage as ms
        from deepwmh_tpu_torch.unet.train import TrainConfig

        Budget = StageBudget
        monkeypatch.setattr(ms, "TrainConfig", functools.partial(TrainConfig, seed=train_seed))
        kw = {"device": "cpu"}
    t0 = time.time()
    res = run_e2e_accuracy(str(tmp_path), budget=Budget(**WITNESS_BUDGET), run_stages="full",
                           **WITNESS_E2E, **kw)
    print("\n" + json.dumps({
        "spread": package, "train_seed": train_seed, "torch_threads": torch.get_num_threads(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""), "heldout_dice": res["dice"],
        "stage1_dice": res["stage1_dice"], "trainfit_dice": res["trainfit_dice"],
        "wall_s": time.time() - t0}))
    assert 0.0 <= res["dice"] <= 1.0
