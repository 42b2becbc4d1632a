"""deepwmh_tpu_torch volume ops against the JAX package on the same inputs:
resizing and z-score (atol 1e-5), Otsu (the same bin), morphology,
connected components, spark removal, the largest component, hole filling
and the brain mask (exactly equal; labels also against scipy.ndimage.label),
and N4 (rtol 1e-3 inside the head; the gap measured on the phantom below
was ~3e-6)."""

import numpy as np
import pytest
import scipy.ndimage as ndi

import jax.numpy as jnp
import torch

from deepwmh_tpu.ops import brain as jbrain
from deepwmh_tpu.ops import components as jcomp
from deepwmh_tpu.ops import grid as jgrid
from deepwmh_tpu.ops import histogram as jhist
from deepwmh_tpu.ops import morphology as jmorph
from deepwmh_tpu.ops.n4 import n4_bias_correction as jn4
from deepwmh_tpu.unet import preprocess as jpre
from deepwmh_tpu_torch.ops import brain, components, grid, histogram, morphology
from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
from deepwmh_tpu_torch.unet import preprocess

from torch_port_fixture import phantom


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blobs(shape, frac, seed):
    """Random 3D mask with about ``frac`` foreground in clusters."""
    rng = np.random.RandomState(seed)
    smooth = ndi.uniform_filter(rng.rand(*shape), size=2)
    return (smooth > np.quantile(smooth, 1 - frac)).astype(np.float32)


# ---------------------------------------------------------------- grid


@pytest.mark.parametrize("n_in,n_out", [(10, 17), (17, 10), (1, 5), (7, 7), (9, 2)])
@pytest.mark.parametrize("axis", [0, 2])
def test_resize_axis_matches_jax(n_in, n_out, axis):
    shape = [4, 5, 6]
    shape[axis] = n_in
    a = np.random.RandomState(n_in * 31 + n_out).randn(*shape).astype(np.float32)
    for port, ref in ((grid.linear_resize_axis, jgrid._linear_resize_axis),
                      (grid.nearest_resize_axis, jgrid._nearest_resize_axis)):
        got = port(_t(a), axis, n_out).numpy()
        want = np.asarray(ref(jnp.asarray(a), axis, n_out))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_nearest_resize_rounds_half_up():
    # floor(x + 0.5): 5 -> 3 samples 0, 2, 4; 4 -> 3 samples 0, 2 (1.5 -> 2), 3
    a = torch.arange(4, dtype=torch.float32)
    assert grid.nearest_resize_axis(a, 0, 3).tolist() == [0.0, 2.0, 3.0]


def test_resample_and_zscore_match_jax():
    vol = phantom((20, 23, 17), seed=2)
    for spacing in [(1.2, 0.9, 2.0), (2.0, 2.0, 2.0)]:
        for order in (0, 1):
            got = preprocess.resample_volume(_t(vol), spacing, (1.0, 1.1, 1.5), order).numpy()
            want = np.asarray(jpre.resample_volume(vol, spacing, (1.0, 1.1, 1.5), order))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5 * vol.max(), rtol=0)
    got = preprocess.normalize_zscore(_t(vol)).numpy()
    v64 = vol.astype(np.float64)
    np.testing.assert_allclose(got, (v64 - v64.mean()) / v64.std(), atol=1e-6, rtol=0)
    # JAX's f32 std is ~9e-6 (relative) off the float64 one on this volume,
    # so the two z-scores differ by a factor, up to ~3e-5 at |z| ~ 3.5
    want = np.asarray(jpre.normalize_zscore(jnp.asarray(vol)))
    print("z-score: port vs float64 %.2e, port vs JAX %.2e, JAX std rel error %.2e" % (
        np.abs(got - (v64 - v64.mean()) / v64.std()).max(), np.abs(got - want).max(),
        abs(float(jnp.std(jnp.asarray(vol))) / v64.std() - 1)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    got = preprocess.resample_to_shape(_t(vol), (31, 9, 17), order=1).numpy()
    want = np.asarray(jpre.resample_to_shape(vol, (31, 9, 17), order=1))
    np.testing.assert_allclose(got, want, atol=1e-5 * vol.max(), rtol=0)
    target = preprocess.padded_shape(vol.shape, (16, 32, 16))
    assert target == jpre.padded_shape(vol.shape, (16, 32, 16))
    np.testing.assert_array_equal(preprocess.pad_to(_t(vol), target).numpy(),
                                  np.asarray(jpre.pad_to(jnp.asarray(vol), target)))


# ---------------------------------------------------------------- histogram


def _bin(thr, lo, hi, nbins=256):
    return int(round((thr - lo) / ((hi - lo) / nbins) - 0.5))


@pytest.mark.parametrize("masked", [False, True])
def test_otsu_threshold_picks_the_same_bin(masked):
    vol = phantom((24, 20, 22), seed=3)
    mask = (vol > 100).astype(np.float32) if masked else None
    got = float(histogram.otsu_threshold(_t(vol), None if mask is None else _t(mask)))
    want = float(jhist.otsu_threshold(jnp.asarray(vol), None if mask is None else jnp.asarray(mask)))
    sel = vol[mask > 0.5] if masked else vol
    lo, hi = float(sel.min()), float(sel.max())
    assert _bin(got, lo, hi) == _bin(want, lo, hi)
    counts = histogram.masked_histogram(_t(vol), torch.tensor(lo), torch.tensor(hi), 64).numpy()
    np.testing.assert_array_equal(
        counts, np.asarray(jhist.masked_histogram(jnp.asarray(vol), lo, hi, 64)))


# ---------------------------------------------------------------- morphology


@pytest.mark.parametrize("iterations", [1, 2])
def test_morphology_matches_jax(iterations):
    m = _blobs((11, 13, 9), 0.4, seed=iterations)
    for port, ref in ((morphology.binary_erosion_3d, jmorph.binary_erosion_3d),
                      (morphology.binary_dilation_3d, jmorph.binary_dilation_3d)):
        np.testing.assert_array_equal(port(_t(m), iterations).numpy(),
                                      np.asarray(ref(jnp.asarray(m), iterations)))


# ---------------------------------------------------------------- components


def _scipy_min_index_labels(m, axes=(0, 1, 2)):
    """Each voxel's label as its 6-connected component's minimum linear
    index (background N), computed with scipy.ndimage.label."""
    N = m.size
    idx = np.arange(N).reshape(m.shape)
    out = np.full(m.shape, N, np.int64)
    if tuple(axes) == (0, 1, 2):
        lab, k = ndi.label(m)
        if k:
            mins = ndi.minimum(idx, lab, index=np.arange(1, k + 1)).astype(np.int64)
            out[lab > 0] = mins[lab[lab > 0] - 1]
        return out
    for z in range(m.shape[0]):  # axes (1, 2): every [0]-slice on its own
        out[z] = np.where(m[z] > 0, _scipy_min_index_labels(m[z:z + 1])[0] + z * m[0].size, N)
    return out


@pytest.mark.parametrize("frac,seed", [(0.25, 0), (0.45, 1), (0.7, 2)])
@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2)])
def test_label_components_exact(frac, seed, axes):
    m = _blobs((9, 14, 12), frac, seed)
    got = components.label_components(_t(m), axes=axes).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcomp.label_components(jnp.asarray(m), axes=axes)))
    np.testing.assert_array_equal(got, _scipy_min_index_labels(m, axes))


def test_label_components_long_spiral():
    """A one-voxel-wide path that doubles back on itself many times."""
    m = np.zeros((3, 15, 15), np.float32)
    m[1, ::2, :] = 1
    m[1, 1::4, -1] = 1
    m[1, 3::4, 0] = 1
    got = components.label_components(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcomp.label_components(jnp.asarray(m))))
    assert len(np.unique(got[m > 0])) == 1


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (1.0, 1.0, 4.0), (0.9, 0.9, 3.0)])
def test_remove_3mm_sparks_exact(spacing):
    m = _blobs((10, 12, 11), 0.12, seed=4)
    assert components.spark_min_volume(spacing) == jcomp.spark_min_volume(spacing)
    got = components.remove_3mm_sparks(_t(m), spacing).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcomp.remove_3mm_sparks(jnp.asarray(m), spacing)))
    assert 0 < got.sum() < m.sum()


@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2)])
def test_largest_component_exact_with_ties(axes):
    m = _blobs((8, 12, 12), 0.2, seed=5)
    tie = np.zeros((6, 9, 9), np.float32)
    tie[:, 1:3, 1:3] = 1  # two equal components in every slice and in 3D:
    tie[:, 5:7, 5:7] = 1  # the raster-first one must win
    for mask in (m, tie):
        got = components.largest_component(_t(mask), axes=axes).numpy()
        want = np.asarray(jcomp.largest_component(jnp.asarray(mask), axes=axes))
        np.testing.assert_array_equal(got, want)
    assert got[:, 1:3, 1:3].all() and not got[:, 5:7, 5:7].any()


# ---------------------------------------------------------------- brain


def test_fill_holes_exact():
    m = 1 - _blobs((12, 11, 13), 0.3, seed=6)
    m[5:8, 5:8, 5:8] = 1
    m[6, 6, 6] = 0  # one cavity for sure
    got = brain.fill_holes(_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbrain.fill_holes(jnp.asarray(m))))
    assert got[6, 6, 6] == 1


@pytest.mark.parametrize("spacing", [(2.0, 2.0, 2.0), (1.0, 1.0, 3.0)])
def test_brain_extract_exact(spacing):
    vol = phantom((30, 28, 26), seed=7)
    got = brain.brain_extract(_t(vol), spacing).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbrain.brain_extract(jnp.asarray(vol), spacing)))
    assert 0.1 < got.mean() < 0.9


# ---------------------------------------------------------------- N4


def test_n4_matches_jax():
    """Full default schedule (3 levels x 50 iterations, shrink 2) on a
    biased phantom with odd axes; prints the measured gap (run with -s)."""
    vol = phantom((30, 34, 27), seed=8)
    got = n4_bias_correction(_t(vol)).numpy()
    want = np.asarray(jn4(jnp.asarray(vol)))
    head = vol > 0
    print("N4 max relative gap inside the head: %.2e"
          % (np.abs(got[head] - want[head]) / np.abs(want[head])).max())
    np.testing.assert_allclose(got[head], want[head], rtol=1e-3, atol=0)
    np.testing.assert_array_equal(got[~head], want[~head])
