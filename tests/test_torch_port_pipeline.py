"""deepwmh_tpu_torch's training pipeline against the JAX package on the CPU,
module by module, on the same files and seeded numpy inputs:

- marker checkpoints set by either package are seen by the other;
- hard Dice and voxel precision / recall equal to 1e-7, empty masks too;
- phantom subjects: labels and lesion GT equal on >= 99.9% of voxels, the
  FLAIR within 1e-3 of its range on >= 99.9%; the same cohort CSV rows;
- ``registration_command`` equal but for the program name, every flag one
  the port's registration CLI takes;
- ``run_train``'s guards exit in both packages before any N4 work;
- stage II's tail (2-5 masking, 2-6 ensembling) within 1e-6 with equal
  labels; stage III's Dice-ranked split and plan equal, ties included;
- stages 2-4 (f32 networks) and 3-5 (bf16, TTA on) from the same
  JAX-written weights: background softmax within atol 5e-3, the 3-5 masks
  > 99.9% equal;
- ``select_components`` / ``binarize_image`` equal.
"""

import functools
import os
import shlex

import numpy as np
import pytest

import jax
import torch

import torch_port_fixture as fx
from deepwmh_tpu.cli import train as jtrain
from deepwmh_tpu.core import artifacts as jartifacts
from deepwmh_tpu.core import nifti as jnifti
from deepwmh_tpu.eval import metrics as jmetrics
from deepwmh_tpu.eval import phantom as jphantom
from deepwmh_tpu.ops import selection as jselection
from deepwmh_tpu.pipeline import multistage as jms
from deepwmh_tpu.unet import checkpoint as jckpt
from deepwmh_tpu_torch.cli import group_register as reg_cli
from deepwmh_tpu_torch.cli import train
from deepwmh_tpu_torch.core import artifacts
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.manifests import write_csv_simple
from deepwmh_tpu_torch.eval import metrics, phantom
from deepwmh_tpu_torch.ops import selection
from deepwmh_tpu_torch.pipeline import multistage as ms

SP2 = (2.0, 2.0, 2.0)


def _hdr(shape, spacing=SP2):
    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(spacing)
    return hdr


def _pipelines(root, budget_kw, cases):
    """The JAX and the port pipeline on folders of their own, the same cases."""
    out = []
    for name, mod, kw in (("jax", jms, {}), ("port", ms, {"device": "cpu"})):
        p = mod.PipelineMultistage(str(root / name), budget=mod.StageBudget(**budget_kw), **kw)
        for c in cases:
            p.add_training_case(c, "unused", [], [], [])
        out.append(p)
    return out


def _load(p):
    return nifti.load_nifti_simple(p)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_markers_cross_package(tmp_path, writer):
    folder = str(tmp_path / "Checkpoints")
    mods = {"jax": jartifacts, "port": artifacts}
    w = mods[writer].Checkpoints(folder)
    r = mods["port" if writer == "jax" else "jax"].Checkpoints(folder)
    assert not r.is_finished("STAGE_2-4_RAW_SOFTMAX")
    w.set_finish("STAGE_2-4_RAW_SOFTMAX")
    assert r.is_finished("STAGE_2-4_RAW_SOFTMAX")
    assert os.listdir(folder) == ["STAGE_2-4_RAW_SOFTMAX"]
    r.clear("STAGE_2-4_RAW_SOFTMAX")
    assert not w.is_finished("STAGE_2-4_RAW_SOFTMAX")
    assert not mods[writer].Checkpoints(folder, enabled=False).is_finished("x")
    good, bad = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    artifacts.atomic_write_json({"k": 1}, good)
    with open(bad, "w") as f:
        f.write("{")
    for path in (good, bad, str(tmp_path / "none.json")):
        assert artifacts.try_load_json(path) == jartifacts.try_load_json(path)


# ---------------------------------------------------------------- metrics


def _metric_case(name):
    rng = np.random.RandomState(3)
    a = (rng.rand(12, 10, 8) > 0.7).astype(np.float32)
    b = (rng.rand(12, 10, 8) > 0.6).astype(np.float32)
    z = np.zeros_like(a)
    return {"random": (a, b), "both_empty": (z, z), "pred_empty": (z, b),
            "truth_empty": (a, z)}[name]


@pytest.mark.parametrize("case", ["random", "both_empty", "pred_empty", "truth_empty"])
def test_metrics_match_jax(case):
    a, b = _metric_case(case)
    assert abs(metrics.hard_dice_binary(a, b) - jmetrics.hard_dice_binary(a, b)) <= 1e-7
    got = metrics.voxel_precision_recall(a, b)
    want = jmetrics.voxel_precision_recall(a, b)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


# ---------------------------------------------------------------- phantom


@pytest.mark.parametrize("lesion", [False, True])
def test_phantom_subject_matches_jax(lesion):
    shape = (24, 28, 24)
    want = jphantom.make_subject(shape, 4, lesion)
    got = phantom.make_subject(shape, 4, lesion, device="cpu")
    for k in ("label1", "label2", "lesion_gt"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert (got[k] == want[k]).mean() >= 0.999, k
    assert want["lesion_gt"].any() == lesion
    span = float(want["flair"].max() - want["flair"].min())
    assert (np.abs(got["flair"] - want["flair"]) <= 1e-3 * span).mean() >= 0.999


def test_phantom_cohort_rows_match_jax(tmp_path):
    kw = dict(shape=(20, 24, 20), spacing=SP2, n_ref=1, n_train=1, seed=5)
    jref, jtr, jgt = jphantom.write_cohort(str(tmp_path / "jax"), **kw)
    ref, tr, gt = phantom.write_cohort(str(tmp_path / "port"), device="cpu", **kw)
    for a, b in ((jref, ref), (jtr, tr)):
        with open(a) as f:
            want = f.read().replace(str(tmp_path / "jax"), "<dir>")
        with open(b) as f:
            assert f.read().replace(str(tmp_path / "port"), "<dir>") == want
    assert list(gt) == list(jgt) == ["SUB00"]
    assert (_load(gt["SUB00"]) == _load(jgt["SUB00"])).mean() >= 0.999


# ------------------------------------------------- the train CLI's pieces


@pytest.mark.parametrize("mode", ["svf", "learned"])
@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_registration_command_matches_jax(mode, quick, large, warm):
    args = ("/o/regsource.csv", "/o/regtarget.csv", "/o/002_Registration", mode, quick, large)
    got = train.registration_command(*args, svf_warm_start=warm)
    want = jtrain.registration_command(*args, svf_warm_start=warm)
    prog = "python -m deepwmh_tpu_torch.cli.group_register "
    assert got.startswith(prog) and want.startswith("deepwmhGroupRegistration ")
    assert got[len(prog):] == want[len("deepwmhGroupRegistration "):]
    # every flag the command emits is one the port's registration CLI takes
    parsed = reg_cli.make_parser().parse_args(shlex.split(got)[3:])
    assert parsed.keep_deformation and parsed.learned == (mode == "learned")


GUARDS = {
    "learned_distributed": dict(registration_mode="learned", distributed="1/2"),
    "warm_learned": dict(registration_mode="learned", svf_warm_start=True),
    "warm_distributed": dict(svf_warm_start=True, distributed="1/2"),
    "overlap": {},
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_run_train_guards_match_jax(tmp_path, guard):
    """Each contradiction exits in both packages before any N4 work."""
    flair = str(tmp_path / "x.nii.gz")
    open(flair, "w").close()
    ref_csv, tr_csv = str(tmp_path / "ref.csv"), str(tmp_path / "tr.csv")
    rows = {"case": ["A"], "desc": ["d"], "flair": [flair]}
    write_csv_simple(ref_csv, {**rows, "label1": [flair], "label2": [flair]})
    write_csv_simple(tr_csv, rows)  # case "A" in both: the overlap guard
    for name, fn, kw in (("jax", jtrain.run_train, {}),
                         ("port", train.run_train, {"device": "cpu"})):
        out = tmp_path / name
        with pytest.raises(SystemExit) as err:
            fn(ref_csv, tr_csv, str(out), **GUARDS[guard], **kw)
        assert err.value.code not in (0, None)
        assert not (out / "001_Preprocessed").exists()


# ------------------------------------------------------- stage II's tail


def test_stage2_tail_matches_jax(tmp_path):
    """2-5 and 2-6 from the same stage-1 artifacts and raw softmax files
    (2-3 and 2-4 marked done): masked fields and the ensemble within 1e-6,
    label_ensembled equal."""
    shape, cases = (20, 18, 16), ["SUB00", "SUB01"]
    rng = np.random.RandomState(11)
    pipes = _pipelines(tmp_path, dict(stage2_epochs=20), cases)
    epochs = [19, 20]
    data = {}
    for c in cases:
        data[c] = {
            "image": (100 + 50 * rng.rand(*shape)).astype(np.float32),
            "valid_mask": (rng.rand(*shape) > 0.1).astype(np.float32),
            "seg_pp": (rng.rand(*shape) > 0.9).astype(np.float32),
        }
        for e in epochs:
            # a speckled background softmax: field < 0.5 leaves sparks
            data[c][e] = (1 / (1 + np.exp(-3 * rng.randn(*shape)))).astype(np.float32)
    for p in pipes:
        for c in cases:
            paths = p._case_paths(c)
            for k in ("image", "valid_mask", "seg_pp"):
                os.makedirs(os.path.dirname(paths[k]), exist_ok=True)
                nifti.save_nifti(data[c][k], _hdr(shape), paths[k])
            for e in epochs:
                nifti.save_nifti(data[c][e], _hdr(shape), os.path.join(
                    p.stage2_folder, "003_raw_softmax", "epoch_%04d" % e, "%s_0.nii.gz" % c))
        for m in ("STAGE_2-3_TRAINING_DENOISER", "STAGE_2-4_RAW_SOFTMAX"):
            p.checkpoints.set_finish(m)
        p._do_label_denoising()
    jp, tp = pipes
    for c in cases:
        for e in epochs:
            rel = os.path.join("004_masked_softmax", "epoch_%04d" % e, "%s_0.nii.gz" % c)
            np.testing.assert_allclose(_load(os.path.join(tp.stage2_folder, rel)),
                                       _load(os.path.join(jp.stage2_folder, rel)), atol=1e-6)
        rel = os.path.join("005_refined_label", c)
        np.testing.assert_allclose(
            _load(os.path.join(tp.stage2_folder, rel, "softmax_ensembled.nii.gz")),
            _load(os.path.join(jp.stage2_folder, rel, "softmax_ensembled.nii.gz")), atol=1e-6)
        got = _load(os.path.join(tp.stage2_folder, rel, "label_ensembled.nii.gz"))
        want = _load(os.path.join(jp.stage2_folder, rel, "label_ensembled.nii.gz"))
        assert 0 < want.sum() < want.size
        np.testing.assert_array_equal(got, want)
    assert tp.checkpoints.is_finished("STAGE_2-6_ENSEMBLING")


# ------------------------------------------------------ stage III's split


@pytest.mark.parametrize("val_fraction", [0.05, 0.5])
def test_stage3_split_and_plan_match_jax(tmp_path, val_fraction):
    """3-1 from the same seg_pp and refined labels: split.json and plan.json
    equal. Cases 1 and 4 tie on Dice, and so do the two empty pairs."""
    shape = (20, 24, 16)
    cases = ["C%d" % i for i in range(6)]
    shifts = [0, 2, 5, 1, 2, None]  # None: both labels empty (Dice 1, as shift 0)
    pipes = _pipelines(tmp_path, dict(val_fraction=val_fraction), cases)
    for p in pipes:
        for c, shift in zip(cases, shifts):
            paths = p._case_paths(c)
            os.makedirs(os.path.dirname(paths["image"]), exist_ok=True)
            seg = np.zeros(shape, np.float32)
            ref = np.zeros(shape, np.float32)
            if shift is not None:
                seg[4:12, 6:14, 4:10] = 1
                ref[4 + shift:12 + shift, 6:14, 4:10] = 1
            nifti.save_nifti(np.ones(shape, np.float32), _hdr(shape), paths["image"])
            nifti.save_nifti(seg, _hdr(shape), paths["seg_pp"])
            out = p._refined_label_path(c)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            nifti.save_nifti(ref, _hdr(shape), out)
        for m in ("STAGE_3-4_TRAINING", "STAGE_3-5_FINAL_FIT"):
            p.checkpoints.set_finish(m)
        p._do_DCNN_training()
    jp, tp = pipes
    for rel in (os.path.join("001_data_partitions", "split.json"),):
        assert artifacts.load_json(os.path.join(tp.stage3_folder, rel)) == \
            artifacts.load_json(os.path.join(jp.stage3_folder, rel))
    split = artifacts.load_json(os.path.join(tp.stage3_folder, "001_data_partitions",
                                             "split.json"))
    assert len(split["val"]) == max(int(6 * val_fraction), 1)
    plan_rel = os.path.join(ms.PipelineMultistage.STAGE3_TASK, "plan.json")
    assert artifacts.load_json(os.path.join(tp.dcnn_folder, plan_rel)) == \
        artifacts.load_json(os.path.join(jp.dcnn_folder, plan_rel))


# ------------------------------------------- stages 2-4 and 3-5, weights


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """Both packages' 2-4 .. 2-6 and 3-5 from the same JAX-written weights:
    the fixture's narrow plan (base 4, max 8, 16^3) with its decisive
    weights as the two ensemble epochs (the second with its head bias
    moved) and as model_best, on two phantom cases.

    Stage 2-4 runs its networks in f32 in both packages: one bf16 forward
    without TTA moves the probability by up to ~2e-2 on the sigmoid's steep
    voxels between the two packages' CPU convolutions (bf16 rounding noise,
    ~4e-3 with 8-flip TTA; the masks stay equal), which would hide the
    orchestration under test. Stage 3-5 runs in bf16, as in production."""
    root = tmp_path_factory.mktemp("swept")
    cases = ["SUB00", "SUB01"]
    plan = fx.tiny_plan()
    vols = {c: fx.phantom(seed=i) for i, c in enumerate(cases)}
    params = fx.decisive_params(plan, vols["SUB00"])
    moved = jax.tree_util.tree_map(np.copy, params)
    moved["seg_head_0"]["bias"][1] += 0.5
    pipes = _pipelines(root, dict(stage2_epochs=20), cases)
    for p in pipes:
        for c in cases:
            paths = p._case_paths(c)
            os.makedirs(os.path.dirname(paths["image"]), exist_ok=True)
            for k in ("image", "normalized"):
                nifti.save_nifti(vols[c], _hdr(fx.SHAPE), paths[k])
            nifti.save_nifti((vols[c] > 0).astype(np.float32), _hdr(fx.SHAPE),
                             paths["valid_mask"])
        for task in (p.STAGE2_TASK, p.STAGE3_TASK):
            plan.save(os.path.join(p._task_dir(task), "plan.json"))
        for ep, tree in ((19, params), (20, moved)):
            jckpt.save_checkpoint(p._train_dir(p.STAGE2_TASK), jckpt.MODEL_EPOCH_FMT % ep, tree)
        jckpt.save_checkpoint(p._train_dir(p.STAGE3_TASK), jckpt.MODEL_BEST, params)
        p.checkpoints.set_finish("STAGE_2-3_TRAINING_DENOISER")
    saved = jms.UNet3D, ms.UNet3D
    jms.UNet3D = functools.partial(saved[0], dtype=jax.numpy.float32)
    ms.UNet3D = functools.partial(saved[1], dtype=torch.float32)
    try:
        for p in pipes:
            p._do_label_denoising()
    finally:
        jms.UNet3D, ms.UNet3D = saved
    for p in pipes:
        artifacts.atomic_write_json({"train": cases[:1], "val": cases[1:]}, os.path.join(
            p.stage3_folder, "001_data_partitions", "split.json"))
        for m in ("STAGE_3-1_DATA_SPLIT", "STAGE_3-4_TRAINING"):
            p.checkpoints.set_finish(m)
        p._do_DCNN_training()
    return pipes, cases


def test_stage2_softmax_sweep_matches_jax(swept):
    (jp, tp), cases = swept
    for c in cases:
        for e in (19, 20):
            rel = os.path.join("003_raw_softmax", "epoch_%04d" % e, "%s_0.nii.gz" % c)
            got, want = (_load(os.path.join(p.stage2_folder, rel)) for p in (tp, jp))
            assert 0.05 < (want < 0.5).mean() < 0.95  # both classes present
            np.testing.assert_allclose(got, want, atol=5e-3)
    assert tp.checkpoints.is_finished("STAGE_2-6_ENSEMBLING")


def test_stage3_training_fit_matches_jax(swept):
    (jp, tp), cases = swept
    for c in cases:
        for rel in ("%s.nii.gz" % c, os.path.join("3mm_postproc", "%s.nii.gz" % c)):
            got, want = (_load(os.path.join(p.stage3_folder, "002_training_fit", rel))
                         for p in (tp, jp))
            assert want.any()
            assert (got == want).mean() > 0.999
    assert tp.checkpoints.is_finished("PIPELINE_TRAINING_COMPLETE")


# ------------------------------------------------------------- selection


@pytest.mark.parametrize("method", ["window", "crossing", "masking"])
def test_select_components_matches_jax(method):
    rng = np.random.RandomState(2)
    mask = (rng.rand(14, 12, 10) > 0.6).astype(np.float32)
    sel = np.zeros_like(mask)
    sel[3:9, 2:10, 2:8] = 1
    got = selection.select_components(torch.from_numpy(mask), torch.from_numpy(sel), method)
    want = np.asarray(jselection.select_components(jax.numpy.asarray(mask),
                                                   jax.numpy.asarray(sel), method))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < mask.sum() or method == "crossing"


def test_binarize_and_noise_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    src = str(tmp_path / "in.nii.gz")
    jnifti.save_nifti(rng.rand(8, 9, 10).astype(np.float32), _hdr((8, 9, 10)), src)
    got = selection.binarize_image(src, 0.4, save_file=str(tmp_path / "p.nii.gz"))
    want = jselection.binarize_image(src, 0.4, save_file=str(tmp_path / "j.nii.gz"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_load(str(tmp_path / "p.nii.gz")),
                                  _load(str(tmp_path / "j.nii.gz")))
    np.testing.assert_array_equal(selection.gaussian_noise_2x2x2((5, 6, 7), 2.0, seed=1),
                                  jselection.gaussian_noise_2x2x2((5, 6, 7), 2.0, seed=1))
