"""deepwmh_tpu_torch inference against the JAX package on the fixture of
tests/torch_port_fixture.py (48x48x40 phantom at 2 mm, tiny plan): the
sweep geometry exactly, and whole-volume and patch sweeps and predict_case
in f32 within atol 1e-4 on the probabilities. The measured gaps are printed
(pytest -s). The bf16 predict_case_full is held against JAX in
tests/test_torch_port_slice.py, beside the run_predict that compiles the
same JAX program."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepwmh_tpu.unet import infer as jinfer
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.preprocess import preprocess_case as jpreprocess
from deepwmh_tpu_torch.unet import infer
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.release import load_released_model

from torch_port_fixture import SPACING, phantom, tiny_plan, write_case


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    image, pkg, params, jplan = write_case(tmp_path_factory.mktemp("infer"))
    return pkg, params, jplan


def test_sweep_geometry_matches_jax():
    for size, patch in [((64, 64, 64), (16, 16, 16)), ((40, 97, 33), (32, 48, 16)),
                        ((10, 10, 10), (16, 16, 16))]:
        assert infer.compute_steps(size, patch) == jinfer.compute_steps(size, patch)
        pos, w = infer.patch_positions(size, patch)
        jpos, jw = jinfer.patch_positions(size, patch)
        np.testing.assert_array_equal(pos, np.asarray(jpos))
        np.testing.assert_array_equal(w, np.asarray(jw))
    np.testing.assert_array_equal(infer.gaussian_importance_map((16, 20, 12)).numpy(),
                                  np.asarray(jinfer.gaussian_importance_map((16, 20, 12))))
    assert infer.FULLVOL_MAX_VOXELS == jinfer.FULLVOL_MAX_VOXELS
    plan, jplan = tiny_plan(Plan), tiny_plan()
    for shape in [(48, 48, 40), (47, 30, 9), (260, 260, 240)]:
        assert infer.fullvol_shape(shape, plan) == jinfer.fullvol_shape(shape, jplan)
        for mode in ("auto", "patch"):
            assert infer.use_fullvol(mode, shape, plan) == jinfer.use_fullvol(mode, shape, jplan)
    with pytest.raises(ValueError, match="FULLVOL_MAX_VOXELS"):
        infer.use_fullvol("fullvol", (260, 260, 240), plan)


@pytest.mark.parametrize("mode,shape", [("fullvol", (48, 48, 40)), ("patch", (20, 24, 18))])
def test_sweeps_match_jax_in_f32(case, mode, shape):
    """predict_volume with every TTA flip: whole-volume TTA, and the
    Gaussian patch sweep (padded to 32^3, 27 positions)."""
    pkg, params, jplan = case
    vol = np.asarray(jpreprocess(jnp.asarray(phantom(shape, seed=1)), SPACING, jplan))
    jpred = jinfer.SlidingWindowPredictor(JUNet3D(plan=jplan, dtype=jnp.float32), params,
                                          jplan, mode=mode)
    want = np.asarray(jpred.predict_volume(vol))
    model, plan = load_released_model(pkg, device="cpu", dtype=torch.float32)
    got = infer.SlidingWindowPredictor(model, plan, mode=mode, device="cpu").predict_volume(vol)
    assert got.shape == want.shape == shape + (2,)
    print("f32 %s sweep: probability max gap %.2e" % (mode, np.abs(got.numpy() - want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_fullvol_tta_matches_jax_on_one_flip(case):
    """fullvol_tta itself, on a flip set of one mirrored forward."""
    pkg, params, jplan = case
    vol = np.asarray(jpreprocess(jnp.asarray(phantom(seed=2)), SPACING, jplan))
    jmodel = JUNet3D(plan=jplan, dtype=jnp.float32)
    model, _ = load_released_model(pkg, device="cpu", dtype=torch.float32)
    flips = ((True, False, True),)
    want = np.asarray(jinfer.fullvol_tta(
        params, jnp.asarray(vol), lambda p, x: jmodel.apply({"params": p}, x), 2, flips))
    with torch.no_grad():
        got = infer.fullvol_tta(model, torch.tensor(vol), 2, flips)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_predict_case_geometry_matches_jax(case):
    """An anisotropic volume whose spacing needs the 4-decimal rounding and
    Python round() of the resampled shape: f32 on both sides, so only the
    geometry can differ."""
    pkg, params, jplan = case
    vol = phantom((40, 52, 14), seed=4)
    spacing = (1.23456, 0.9, 3.1)
    jpred = jinfer.SlidingWindowPredictor(JUNet3D(plan=jplan, dtype=jnp.float32), params, jplan)
    want = [np.asarray(o) for o in jpred.predict_case(vol, spacing)]
    model, plan = load_released_model(pkg, device="cpu", dtype=torch.float32)
    got = [o.numpy() for o in
           infer.SlidingWindowPredictor(model, plan, device="cpu").predict_case(vol, spacing)]
    assert got[0].shape == want[0].shape == vol.shape and got[0].dtype == want[0].dtype
    assert (got[0] == want[0]).mean() > 0.999
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    assert 0.01 < want[0].mean() < 0.9
