"""The OASIS-3 recipe (PARITY C13) on the port
(deepwmh_tpu_torch.experiments.oasis3) against the JAX package's
experiments/010_OASIS3, on the JAX test's mocked 24x24x20 heads, the port
on the CPU.

Whole affine registrations cannot be compared value by value at these
sizes (one MI level at 8^3 is chaotic), so ``prepare_reference_case`` is
held to the repo's brain floor in each package (label1 against the
phantom's brain, Dice >= 0.85) and the two label1s to each other (Dice >=
0.90). ``evaluate_training_fit`` writes the same CSV to 1e-12 on the same
masks. The whole ``main()`` of both packages runs on the mocked tree as its
JAX counterpart does, marked slow as that one is (a whole ``run_train``).
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from deepwmh_tpu.core import nifti as jnifti
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.experiments.oasis3 import run_oasis3 as port
from deepwmh_tpu_torch.experiments.oasis3.cohorts import COHORTS

EXP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "experiments", "010_OASIS3")
sys.path.insert(0, EXP_DIR)

import run_oasis3 as jax_recipe  # noqa: E402
from cohorts import COHORTS as JAX_COHORTS  # noqa: E402

SHAPE = (24, 24, 20)
BRAIN_DICE_FLOOR = 0.85
CROSS_DICE_FLOOR = 0.90


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _head(shape, seed, lesion=False):
    """tests/test_oasis3_experiment.py's head."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a**2 for a in g))
    brain = (r < 0.8).astype(np.float32)
    vol = brain * (200 + 30 * np.cos(3 * g[0]) + 8 * rng.randn(*shape))
    les = np.zeros(shape, np.float32)
    if lesion:
        les[10:14, 10:14, 8:12] = 1.0
        les *= brain
        vol = vol + 160 * les
    return vol.astype(np.float32), brain, les


def _header():
    hdr = nifti.NiftiHeader()
    hdr.set_shape(SHAPE)
    hdr.set_zooms((2.0, 2.0, 2.0))
    return hdr


def _dice(a, b):
    a, b = a > 0.5, b > 0.5
    return 2.0 * (a & b).sum() / max(a.sum() + b.sum(), 1)


def test_cohorts_match_jax():
    assert COHORTS == JAX_COHORTS
    assert len(COHORTS["mMR"]["training"]) == 100 and len(COHORTS["TrioTim"]["training"]) == 50


def test_prepare_reference_case_meets_the_brain_floor(tmp_path):
    hdr = _header()
    vol, brain, _ = _head(SHAPE, seed=0)
    flair, t1 = str(tmp_path / "flair.nii.gz"), str(tmp_path / "t1w.nii.gz")
    nifti.save_nifti(vol, hdr, flair)
    # the T1w a voxel off the FLAIR grid, so the T1w -> FLAIR affine has work
    nifti.save_nifti(np.roll(vol * 0.8, 1, axis=0), hdr, t1)
    avol, abrain, _ = _head(SHAPE, seed=99)
    nifti.save_nifti(avol, hdr, str(tmp_path / "atlas_img.nii.gz"))
    nifti.save_nifti(abrain, hdr, str(tmp_path / "atlas_lbl.nii.gz"))
    args = ("ref0", t1, flair, str(tmp_path / "atlas_img.nii.gz"),
            str(tmp_path / "atlas_lbl.nii.gz"))
    j1, j2 = jax_recipe.prepare_reference_case(*args, str(tmp_path / "jax"))
    p1, p2 = port.prepare_reference_case(*args, str(tmp_path / "port"), device="cpu")
    assert os.path.basename(p1) == os.path.basename(j1) == "t2flair_raw_brain_mask.nii.gz"
    assert os.path.basename(p2) == os.path.basename(j2) == "t2flair_raw_brain_priors.nii.gz"
    jl1, jl2 = jnifti.load_nifti_simple(j1), jnifti.load_nifti_simple(j2)
    (pl1, h1), pl2 = nifti.load_nifti(p1), nifti.load_nifti_simple(p2)
    assert pl1.shape == pl2.shape == SHAPE and h1.zooms[:3] == (2.0, 2.0, 2.0)
    dices = {"jax": _dice(jl1, brain), "port": _dice(pl1, brain), "cross": _dice(pl1, jl1),
             "label2_cross": _dice(pl2, jl2)}
    print("label1 Dice: %s" % dices)
    assert dices["jax"] >= BRAIN_DICE_FLOOR and dices["port"] >= BRAIN_DICE_FLOOR
    assert dices["cross"] >= CROSS_DICE_FLOOR
    assert set(np.unique(pl1).tolist()) <= {0.0, 1.0}
    assert set(np.unique(pl2).tolist()) <= {0.0, 1.0} and pl2.sum() > 0
    # idempotent: a second call resumes from the artifacts
    mtime = os.path.getmtime(p1)
    assert port.prepare_reference_case(*args, str(tmp_path / "port"), device="cpu") == (p1, p2)
    assert os.path.getmtime(p1) == mtime


def _rater_tree(root, cases, n_missing=1):
    """Per case a lesion mask, a dilated second rater and a prediction that
    overlaps both; the last ``n_missing`` cases lack their second rater."""
    hdr = _header()
    fit, raters = os.path.join(root, "fit"), os.path.join(root, "raters")
    os.makedirs(fit)
    for i, case in enumerate(cases):
        rng = np.random.RandomState(i)
        les = np.zeros(SHAPE, np.float32)
        c = rng.randint(6, 14, 3)
        les[c[0]:c[0] + 5, c[1]:c[1] + 4, c[2]:c[2] + 3] = 1
        r2 = les.copy()
        r2[c[0] - 1:c[0] + 6, c[1]:c[1] + 5, c[2]:c[2] + 4] = 1
        pred = (rng.rand(*SHAPE) < 0.02).astype(np.float32) + np.roll(les, i % 3, axis=0)
        os.makedirs(os.path.join(raters, case))
        nifti.save_nifti(les, hdr, os.path.join(raters, case, "rater_1.nii.gz"))
        if i < len(cases) - n_missing:
            nifti.save_nifti(r2, hdr, os.path.join(raters, case, "rater_2.nii.gz"))
        nifti.save_nifti(np.minimum(pred, 1), hdr, os.path.join(fit, "%s.nii.gz" % case))
    return fit, raters


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [[r[0]] + [float(v) for v in r[1:]] for r in rows[1:]]


def test_evaluate_training_fit_matches_jax(tmp_path):
    cases = COHORTS["mMR"]["training"][:4]
    fit, raters = _rater_tree(str(tmp_path), cases)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    want = jax_recipe.evaluate_training_fit(cases, fit, raters, str(tmp_path / "jax"))
    got = port.evaluate_training_fit(cases, fit, raters, str(tmp_path / "port"), device="cpu")
    (jhead, jrows), (phead, prows) = _read_csv(want), _read_csv(got)
    assert phead == jhead == ["case", "intra-rater_variability", "proposed_vs_rater1",
                              "proposed_vs_rater2"]
    assert [r[0] for r in prows] == [r[0] for r in jrows] == cases[:3]
    np.testing.assert_allclose(np.array([r[1:] for r in prows]),
                               np.array([r[1:] for r in jrows]), rtol=0, atol=1e-12)
    assert min(r[1] for r in prows) > 0.4
    assert port.evaluate_training_fit(cases, fit, str(tmp_path / "none"),
                                      str(tmp_path / "port"), device="cpu") is None


def test_mesh_exits_naming_a13(tmp_path, monkeypatch, capsys):
    """The name is the refusal's this test replaced: --mesh now runs. With
    make_mesh stood in by a 2-shard CPU mesh, the recipe preps on the
    mesh's device and hands the mesh to run_train (both stood in here; the
    whole recipe is the slow test below); --mesh with --device exits."""
    from deepwmh_tpu_torch.cli import train as train_cli
    from deepwmh_tpu_torch.parallel.mesh import Mesh

    base = ["--oasis3-folder", str(tmp_path), "--atlas-image", "a", "--atlas-label", "b",
            "--limit-reference", "1", "--limit-training", "1", "--output", str(tmp_path / "o"),
            "--rater-dir", str(tmp_path / "no_raters")]
    with pytest.raises(SystemExit):
        port.main(base + ["--mesh", "--device", "cpu"])
    case = COHORTS["mMR"]["reference"][0]
    os.makedirs(tmp_path / case)
    for name in (port.T1W_FILENAME, port.T2FLAIR_FILENAME):
        open(tmp_path / case / name, "w").close()
    mesh = Mesh(["cpu"] * 2)
    seen = {}
    monkeypatch.setattr(train_cli, "make_mesh", lambda: mesh)

    def prep(*a, device=None):
        seen["prep"] = device
        return "l1", "l2"

    def run_train(*a, **kw):
        seen["train"] = kw
        return str(tmp_path / "core")

    monkeypatch.setattr(port, "prepare_reference_case", prep)
    monkeypatch.setattr(train_cli, "run_train", run_train)
    port.main(base + ["--mesh"])
    assert seen["prep"] == torch.device("cpu")
    assert seen["train"]["mesh"] is mesh and seen["train"]["device"] is None
    assert "mesh: 2 device(s) (cpu)" in capsys.readouterr().out


@pytest.mark.slow
def test_main_end_to_end_matches_jax(tmp_path):
    """Both packages' whole recipe (prep -> train -> evaluation) on the JAX
    test's mocked tree: the same artifacts and CSV layout, label1 at the
    brain floor in each and the two runs' training-fit evaluations over the
    same cases."""
    hdr = _header()
    cohort = COHORTS["mMR"]
    ref_cases, train_cases = cohort["reference"][:2], cohort["training"][:2]
    root, rater_dir = tmp_path / "OASIS3", tmp_path / "raters"
    brains = {}
    for i, case in enumerate(ref_cases + train_cases):
        os.makedirs(root / case)
        vol, brains[case], les = _head(SHAPE, seed=i if i < 2 else 8 + i, lesion=i >= 2)
        nifti.save_nifti(vol, hdr, str(root / case / "t2flair_raw.nii.gz"))
        nifti.save_nifti(vol * 0.8, hdr, str(root / case / "t1w_raw.nii.gz"))
        if i >= 2:
            os.makedirs(rater_dir / case)
            nifti.save_nifti(les, hdr, str(rater_dir / case / "rater_1.nii.gz"))
            r2 = np.zeros_like(les)
            r2[9:15, 9:15, 7:13] = 1.0
            nifti.save_nifti(r2, hdr, str(rater_dir / case / "rater_2.nii.gz"))
    avol, abrain, _ = _head(SHAPE, seed=99)
    nifti.save_nifti(avol, hdr, str(tmp_path / "atlas_img.nii.gz"))
    nifti.save_nifti(abrain, hdr, str(tmp_path / "atlas_lbl.nii.gz"))
    argv = ["--oasis3-folder", str(root), "--atlas-image", str(tmp_path / "atlas_img.nii.gz"),
            "--atlas-label", str(tmp_path / "atlas_lbl.nii.gz"), "--scanner", "mMR",
            "--rater-dir", str(rater_dir), "--limit-reference", "2", "--limit-training", "2",
            "--stage2-epochs", "2", "--stage3-epochs", "2", "--batches-per-epoch", "2",
            "--batch-size", "2", "--skip-bfc"]
    outs = {"jax": jax_recipe.main(argv + ["--output", str(tmp_path / "jax")]),
            "port": port.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])}
    heads = {}
    for name, out in outs.items():
        for case in ref_cases:
            l1 = nifti.load_nifti_simple(os.path.join(out, "Reference_prep", case,
                                                      "t2flair_raw_brain_mask.nii.gz"))
            assert _dice(l1, brains[case]) >= BRAIN_DICE_FLOOR, (name, case)
        assert os.path.isfile(os.path.join(out, "Siemens_Biograph_mMR_reference.csv"))
        heads[name], rows = _read_csv(os.path.join(out, "Evaluation_training_fit.csv"))
        assert [r[0] for r in rows] == train_cases
        assert rows[0][1] > 0.4  # the intra-rater Dice of the overlapping raters
    assert heads["port"] == heads["jax"]
