"""The whole first slice of deepwmh_tpu_torch: DeepWMH_predict through the
port's run_predict (on the CPU, asked for explicitly) against the JAX
package's run_predict on the same NIfTI and model package, the staged
resume path against the fused one, the CLI's device rules, and the port's
independence from JAX (a subprocess and a scan of its imports).

Tolerances: > 99.9% voxel agreement on each segmentation artifact, the N4
artifact within rtol 1e-3 inside the head (bf16 compute; the fixture makes
about a third of the head foreground, so the masks compared are not
empty)."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepwmh_tpu.cli.predict import run_predict as jax_run_predict
from deepwmh_tpu.unet import infer as jinfer
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu_torch.cli import predict as cli
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.unet import infer
from deepwmh_tpu_torch.unet.infer import SlidingWindowPredictor
from deepwmh_tpu_torch.unet.release import load_released_model

from torch_port_fixture import SPACING, phantom, tiny_plan, write_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = "subj01"
ARTIFACTS = {
    "pre": "001_Preprocessed_Images/%s_0000.nii.gz" % CASE,
    "raw": "002_Segmentations/001_raw/%s.nii.gz" % CASE,
    "3mm": "002_Segmentations/002_postproc_3mm/%s.nii.gz" % CASE,
    "fov": "002_Segmentations/003_postproc_fov/%s.nii.gz" % CASE,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    image, pkg, params, jplan = write_case(root)
    jax_run_predict([image], [CASE], pkg, str(root / "jax"), make_previews=False)
    cli.run_predict([image], [CASE], pkg, str(root / "port"), device="cpu")
    return root, image, pkg, params, jplan


def _load(out, key):
    return nifti.load_nifti(os.path.join(out, ARTIFACTS[key]))


def test_artifacts_match_jax(runs):
    root, image, *_ = runs
    vol, hdr_in = nifti.load_nifti(image)
    head = vol > 0
    for key in ARTIFACTS:
        got, hdr = _load(root / "port", key)
        want, jhdr = _load(root / "jax", key)
        assert got.shape == want.shape == vol.shape and got.dtype == want.dtype
        assert hdr.zooms == jhdr.zooms == hdr_in.zooms
        np.testing.assert_array_equal(hdr.affine, jhdr.affine)
        if key == "pre":
            print("N4 artifact: max rel gap %.2e"
                  % (np.abs(got[head] - want[head]) / want[head]).max())
            np.testing.assert_allclose(got[head], want[head], rtol=1e-3, atol=0)
        else:
            print("%s artifact: agreement %.6f, fg fraction %.4f"
                  % (key, (got == want).mean(), want.mean()))
            assert (got == want).mean() > 0.999, key
            assert 0.02 < want.mean() < 0.5, (key, want.mean())
    assert os.path.isfile(root / "port" / "003_Previews" / ("%s.gif" % CASE))


@pytest.mark.parametrize("deleted", [("fov",), ("raw", "3mm", "fov"), ("pre",)])
def test_staged_resume_matches_fused(runs, tmp_path, deleted):
    """Rerunning after losing artifacts recomputes just those, stage by
    stage, and gives what the fused fresh-case run gave."""
    root, image, pkg, *_ = runs
    out = tmp_path / "port"
    shutil.copytree(root / "port", out)
    for key in deleted:
        os.remove(out / ARTIFACTS[key])
    kept = {key: os.path.getmtime(out / ARTIFACTS[key]) for key in ARTIFACTS if key not in deleted}
    cli.run_predict([image], [CASE], pkg, str(out), device="cpu", make_previews=False)
    for key in ARTIFACTS:
        got, _ = _load(out, key)
        want, _ = _load(root / "port", key)
        if key == "pre":  # a fresh N4 run of the same input
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert kept == {key: os.path.getmtime(out / ARTIFACTS[key]) for key in kept}


def test_predict_case_full_matches_jax_bf16(runs):
    """The fused case program in bf16, on another phantom of the fixture's
    geometry (the JAX program run_predict compiled is reused). With N4, as
    the main path runs: without it the bias field leaves
    more voxels on steep parts of the sigmoid, where bf16 rounding alone
    moves the fg probability by more than 5e-3 (as it does between the JAX
    package's own two conv lowerings, depth-decomposed and plain)."""
    _, _, pkg, params, jplan = runs
    vol = phantom(seed=3)
    jpred = jinfer.SlidingWindowPredictor(JUNet3D(plan=jplan), params, jplan)
    want = [np.asarray(o) for o in jpred.predict_case_full(vol, SPACING, apply_n4=True)]
    model, plan = load_released_model(pkg, device="cpu")
    got = [o.numpy() for o in
           infer.SlidingWindowPredictor(model, plan, device="cpu").predict_case_full(
               vol, SPACING, apply_n4=True)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    head = vol > 0
    np.testing.assert_allclose(got[0][head], want[0][head], rtol=1e-3, atol=0)
    print("bf16 predict_case_full: mask agreement %s, fg max gap %.2e, N4 max rel gap %.2e"
          % ([float((got[i] == want[i]).mean()) for i in (1, 2, 3)],
             np.abs(got[4] - want[4]).max(),
             (np.abs(got[0][head] - want[0][head]) / want[0][head]).max()))
    for i in (1, 2, 3):
        assert (got[i] == want[i]).mean() > 0.999
    np.testing.assert_allclose(got[4], want[4], atol=5e-3, rtol=0)
    assert 0.02 < want[1].mean() < 0.5  # a mask worth comparing


def test_cli_runs_on_the_cpu_when_asked(runs, tmp_path, capsys):
    _, image, pkg, *_ = runs
    out = tmp_path / "cli"
    cli.main(["-i", image, "-n", "c1", "-m", pkg, "-o", str(out), "--device", "cpu",
              "--skip-bfc", "--disable-tta", "--no-previews"])
    assert "[OK] running on the CPU" in capsys.readouterr().out
    seg = nifti.load_nifti_simple(str(out / "002_Segmentations/003_postproc_fov/c1.nii.gz"))
    assert set(np.unique(seg).tolist()) <= {0.0, 1.0}


def test_no_quiet_fallback_to_the_cpu(runs, tmp_path, monkeypatch):
    """Without a CUDA device, every entry point that was not asked for the
    CPU raises."""
    _, image, pkg, *_ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPU explicitly"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:1")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        load_released_model(pkg)
    model, plan = load_released_model(pkg, device="cpu")
    with pytest.raises(RuntimeError):
        SlidingWindowPredictor(model, plan)
    argv = ["-i", image, "-n", "c1", "-m", pkg, "-o", str(tmp_path / "o")]
    with pytest.raises(SystemExit):  # the integrity check fails
        cli.main(argv)
    with pytest.raises(RuntimeError):
        cli.main(argv + ["--skip-integrity-check"])
    with pytest.raises(SystemExit):
        cli.main(argv + ["-g", "0", "--device", "cpu"])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "deepwmh_tpu"


def test_port_sources_import_no_jax():
    files = sorted(glob.glob(os.path.join(REPO, "deepwmh_tpu_torch", "**", "*.py"), recursive=True))
    # chip_smoke.py and the fixtures it imports on a machine without JAX
    files += [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", name) for name in ("torch_port_dicom.py", "torch_port_nnunet.py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += ["%s: %s" % (os.path.relpath(path, REPO), n) for n in names if _forbidden(n)]
    assert not bad, bad
    assert not _forbidden("deepwmh_tpu_torch.ops") and _forbidden("deepwmh_tpu.ops")


_ISOLATED = r"""
import importlib, os, pkgutil, sys
import numpy as np, torch
import chip_smoke, deepwmh_tpu_torch
for info in pkgutil.walk_packages(deepwmh_tpu_torch.__path__, "deepwmh_tpu_torch."):
    importlib.import_module(info.name)
from deepwmh_tpu_torch.cli.predict import run_predict
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.release import write_model_package

root = sys.argv[1]
plan = Plan(target_spacing=[2.0] * 3, patch_size=[16] * 3, batch_size=2,
            pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
            base_features=4, max_features=8)
model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
pkg = write_model_package(os.path.join(root, "pkg"), model, plan)
vol = chip_smoke.synthetic_flair((24, 28, 20), seed=0)
hdr = nifti.NiftiHeader()
hdr.set_shape(vol.shape)
hdr.set_zooms((2.0, 2.0, 2.0))
image = os.path.join(root, "s.nii.gz")
nifti.save_nifti(vol, hdr, image)
run_predict([image], ["s"], pkg, os.path.join(root, "out"), tta=False, device="cpu")
assert os.path.isfile(os.path.join(root, "out", "002_Segmentations", "003_postproc_fov", "s.nii.gz"))
top = lambda m: m.split(".")[0]
print("LOADED", sorted(m for m in sys.modules if top(m) in ("jax", "jaxlib", "flax", "deepwmh_tpu")))
"""


def test_port_runs_without_jax_in_a_subprocess(tmp_path):
    """Every port module imported and the tiny predict run on the CPU in a
    fresh interpreter: no jax, flax or deepwmh_tpu module gets loaded."""
    proc = subprocess.run([sys.executable, "-c", _ISOLATED, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line. Alone in a
    directory, without the repository: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


@pytest.mark.parametrize("flagship", [True, False])
def test_chip_smoke_flop_count_matches_jax(flagship):
    """chip_smoke's analytic forward FLOPs, the port's ``unet/flops.py``
    (it keeps no count of its own), equal deepwmh_tpu.unet.flops'."""
    import chip_smoke
    from deepwmh_tpu.unet import flops as jflops
    from deepwmh_tpu.unet.plan import Plan as JPlan
    from deepwmh_tpu.unet.plan import default_plan_1mm_iso as jdefault
    from deepwmh_tpu_torch.unet.flops import forward_flops
    from deepwmh_tpu_torch.unet.plan import Plan, default_plan_1mm_iso

    if flagship:
        plan, jplan, shape = default_plan_1mm_iso(), jdefault(), (192, 224, 192)
    else:
        plan, jplan, shape = tiny_plan(Plan), tiny_plan(JPlan), (48, 48, 40)
    assert not hasattr(chip_smoke, "forward_flops")
    assert forward_flops(plan, shape) == jflops.forward_flops(jplan, shape)


def test_nifti_and_dataset_checks_match_jax(tmp_path):
    """The port's NIfTI copy writes the JAX package's bytes and reads its
    files; its dataset check accepts and refuses what the JAX one does."""
    from deepwmh_tpu.core import manifests as jmanifests
    from deepwmh_tpu.core import nifti as jnifti
    from deepwmh_tpu_torch.core import manifests

    vol = np.random.RandomState(0).rand(5, 6, 7).astype(np.float32)
    for mod, name in ((nifti, "port"), (jnifti, "jax")):
        hdr = mod.NiftiHeader()
        hdr.set_shape(vol.shape)
        hdr.set_zooms((0.9, 1.1, 3.0))
        mod.save_nifti(vol, hdr, str(tmp_path / ("%s.nii" % name)))
        mod.save_nifti(vol, hdr, str(tmp_path / ("%s.nii.gz" % name)))
    assert (tmp_path / "port.nii").read_bytes() == (tmp_path / "jax.nii").read_bytes()
    data, hdr = nifti.load_nifti(str(tmp_path / "jax.nii.gz"))
    np.testing.assert_array_equal(data, vol)
    assert nifti.get_nifti_pixdim(str(tmp_path / "jax.nii.gz")) == [
        float(np.float32(z)) for z in (0.9, 1.1, 3.0)]
    assert nifti.try_load_nifti(str(tmp_path / "port.nii.gz"))
    (tmp_path / "torn.nii.gz").write_bytes((tmp_path / "port.nii.gz").read_bytes()[:100])
    assert not nifti.try_load_nifti(str(tmp_path / "torn.nii.gz"))
    img = str(tmp_path / "port.nii.gz")
    for ds in ({"case": ["a1", "b_2"], "flair": [img, img]},
               {"case": ["a1", "a1"], "flair": [img, img]},
               {"case": ["x_to_y"], "flair": [img]},
               {"case": ["bad name"], "flair": [img]},
               {"case": ["c"], "flair": [str(tmp_path / "missing.nii.gz")]}):
        assert manifests.check_dataset(ds, verbose=False) == jmanifests.check_dataset(ds, verbose=False)
