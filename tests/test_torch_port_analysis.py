"""Stage-1 NLL lesion analysis of deepwmh_tpu_torch against the JAX package,
on the CPU: every module of the path on the same numpy inputs, the K2 plain
version against the Pallas kernel in interpret mode, the whole core, and
both packages' LesionAnalyzer on the same NIfTI files.

Tolerances, each with its reason:
- stats, NLL, mean_std_grid: 1e-5 of the array's largest magnitude (f32
  sums in torch's order, not XLA's, err by a few ulps of that scale);
- histogram curves: equal in every bin that no value lies within 1e-5
  (relative) of an edge of, since the bin width comes from such a sum;
- the auto-threshold, component filtering, label vote, median filters and
  median_3mm: exact (selections, counts and integer logic);
- the whole core (the limits of chip_smoke.py's stage1_card_vs_cpu): the
  anomaly within 1e-4 of max |anomaly|, the threshold equal or one
  histogram bin apart, masks and segmentations >= 99.9% equal, the averaged
  label exactly equal.
"""

import importlib
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from deepwmh_tpu.ops import components as jcomp
from deepwmh_tpu.ops import filters as jfilt
from deepwmh_tpu.ops import grid as jgrid
from deepwmh_tpu.ops import histogram as jhist
from deepwmh_tpu.ops import stats as jstats
from deepwmh_tpu.ops.pallas_kernels import median3_pallas
from deepwmh_tpu.pipeline import analysis as janalysis
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.ops import components, filters, grid, histogram, kernels, nll, stats
from deepwmh_tpu_torch.pipeline import analysis

# deepwmh_tpu.ops re-exports the function nll under the module's name
jnll = importlib.import_module("deepwmh_tpu.ops.nll")

RTOL = 1e-5
ANOMALY_TOL = 1e-4  # of max |anomaly|
MASK_AGREEMENT = 0.999

# the whole-slice cohort: K even, so the auto-threshold averages two middles
SLICE_SHAPE = (40, 48, 40)
SLICE_SPACING = (2.0, 2.0, 2.0)
SLICE_K = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once (pytest-xdist);
    torch's intra-op threads then oversubscribe the cores, and the many
    small ops of the stage-1 path slow down more than tenfold (measured
    264 s against 10 s for one test, six processes at once on 8 cores).
    This module runs torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol * max |want| everywhere: sums in another order
    err by a few ulps of the array's scale, not of each element."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _volume(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _mask(shape, seed, frac=0.6):
    return (np.random.RandomState(seed).rand(*shape) < frac).astype(np.float32)


# ---------------------------------------------------------------- stats


@pytest.mark.parametrize("name", ["masked_mean", "masked_std", "z_score", "z_score_masked",
                                  "group_mean", "group_std", "group_masked_nan"])
def test_stats_match_jax(name):
    x = _volume((9, 10, 11), 1, scale=30.0) + 200.0
    m = _mask(x.shape, 2)
    stack = _volume((5, 9, 10, 11), 3, scale=4.0) + 50.0
    masks = _mask(stack.shape, 4, frac=0.5)
    masks[:, 0, 0, 0] = 0.0  # a voxel no member covers: NaN
    stack[1, 1, 1, 1] = np.nan  # a NaN in the input is left out
    calls = {
        "masked_mean": lambda s, a, b: s.masked_mean(a, b),
        "masked_std": lambda s, a, b: s.masked_std(a, b),
        "z_score": lambda s, a, b: s.z_score(a),
        "z_score_masked": lambda s, a, b: s.z_score(a, mask=b),
        "group_mean": lambda s, a, b: s.group_mean(a),
        "group_std": lambda s, a, b: s.group_std(a),
        "group_masked_nan": lambda s, a, b: s.group_std(a, masks=b),
    }
    group = name.startswith("group")
    a, b = (stack, masks) if group else (x, m)
    want = _np(calls[name](jstats, jnp.asarray(a), jnp.asarray(b)))
    got = _np(calls[name](stats, _t(a), _t(b)))
    assert (np.isnan(got) == np.isnan(want)).all()
    if name == "group_masked_nan":
        assert np.isnan(got[0, 0, 0])
    _close(np.nan_to_num(got), np.nan_to_num(want))


# ---------------------------------------------------------------- nll


@pytest.mark.parametrize("side", [None, "+", "-"])
@pytest.mark.parametrize("use_mask,min_std", [(False, 0.03), (True, None)])
def test_nll_matches_jax(side, use_mask, min_std):
    refs = _volume((6, 10, 12, 9), 5) + np.linspace(0, 3, 9, dtype=np.float32)
    x = _volume((10, 12, 9), 6, scale=1.5) + np.linspace(0, 3, 9, dtype=np.float32)
    want = jnll.nll(jnp.asarray(x), jnp.asarray(refs), min_std=min_std, side=side,
                    return_all=True, use_mask=use_mask)
    got = nll.nll(_t(x), _t(refs), min_std=min_std, side=side, return_all=True,
                  use_mask=use_mask)
    for g, w in zip(got, want):
        _close(np.nan_to_num(_np(g)), np.nan_to_num(_np(w)))
    assert (_np(got[0]) != 0).mean() > 0.2


# ---------------------------------------------------------------- grid


@pytest.mark.parametrize("patch", [(5, 7, 9), (25, 25, 25), (3, 11, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_mean_std_grid_matches_jax(patch, masked):
    x = _volume((23, 26, 21), 7, scale=2.0) + np.linspace(-3, 3, 21, dtype=np.float32)
    m = _mask(x.shape, 8, frac=0.7) if masked else None
    m_j = None if m is None else jnp.asarray(m)
    m_t = None if m is None else _t(m)
    for order in (1, 0):
        want = jgrid.mean_std_grid(jnp.asarray(x), patch, mask=m_j, order=order)
        got = grid.mean_std_grid(_t(x), patch, mask=m_t, order=order)
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------------- histograms


def _edge_bins(values, edges, rel=1e-5):
    """Bins whose population a tiny move of the edges can change: those
    beside any edge that some value lies within ``rel`` of."""
    scale = max(float(np.abs(edges).max()), 1e-30)
    near = np.zeros(len(edges) - 1, bool)
    v = np.sort(values.reshape(-1).astype(np.float64))
    for i, e in enumerate(edges):
        j = np.searchsorted(v, e - rel * scale)
        if j < len(v) and v[j] <= e + rel * scale:
            near[max(i - 1, 0):min(i + 1, len(near))] = True
    return near


def test_histogram_analysis_matches_jax():
    rng = np.random.RandomState(9)
    shape = (12, 14, 10)
    a_refs = np.abs(rng.standard_cauchy((5,) + shape)).astype(np.float32)
    a_refs *= rng.rand(*a_refs.shape) < 0.7
    a_prime = np.abs(rng.standard_cauchy(shape)).astype(np.float32) * 1.3
    mask = _mask(shape, 10, frac=0.8)
    want = [_np(w) for w in jhist.histogram_analysis(
        jnp.asarray(a_prime), jnp.asarray(a_refs), jnp.asarray(mask))]
    got = [_np(g) for g in histogram.histogram_analysis(_t(a_prime), _t(a_refs), _t(mask))]
    _close(got[0], want[0], rtol=1e-6)
    width = 2 * float(want[0][0])
    edges = width * np.arange(len(want[0]) + 1)
    for g, w, vals in ((got[1], want[1], a_prime), (got[3], want[3], a_refs)):
        free = ~_edge_bins(vals, edges)
        # equal counts; log10 of them may round 1 ulp apart in two libms
        np.testing.assert_allclose(g[..., free], w[..., free], rtol=2.5e-7, atol=0)
    _close(got[2], want[2])
    x, curve = histogram.hist_curve(_t(a_prime), 0.0, 5.0, 50, mask=_t(mask))
    wx, wcurve = jhist.hist_curve(jnp.asarray(a_prime), 0.0, 5.0, 50, mask=jnp.asarray(mask))
    _close(x, wx, rtol=1e-6)
    np.testing.assert_allclose(_np(curve), _np(wcurve), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("k,never", [(4, ()), (10, ()), (6, (1, 4)), (5, (2,))])
def test_auto_threshold_even_k_averages_the_middles(k, never):
    """An even count of crossings (K = 4, 10, or 6 with two references
    that never cross) takes the mean of the two middles, as jnp.nanmedian
    does; torch.nanmedian would take the lower one."""
    nbins = 40
    x = (np.arange(nbins, dtype=np.float32) + 0.5) * 0.25
    rng = np.random.RandomState(k)
    last = rng.choice(np.arange(3, nbins), size=k, replace=False)
    curves = np.zeros((k, nbins), np.float32)
    for i, b in enumerate(last):
        curves[i, :b + 1] = rng.rand(b + 1) + 0.5
        curves[i, b + 1:] = 0.005  # under the cutoff
    for i in never:  # above the cutoff only in bin 0, which never counts
        curves[i] = 0.0
        curves[i, 0] = 1.0
    want = float(jhist.auto_threshold_from_curves(jnp.asarray(x), jnp.asarray(curves)))
    got = histogram.auto_threshold_from_curves(_t(x), _t(curves))
    assert float(got) == want
    crossings = np.sort(np.delete(x[last], list(never)))
    if len(crossings) % 2 == 0:
        assert float(torch.nanmedian(_t(crossings))) != want


def test_auto_threshold_without_crossings_is_nan():
    curves = np.zeros((4, 10), np.float32)
    x = np.arange(10, dtype=np.float32)
    assert np.isnan(float(histogram.auto_threshold_from_curves(_t(x), _t(curves))))
    assert np.isnan(float(jhist.auto_threshold_from_curves(jnp.asarray(x), jnp.asarray(curves))))


# ---------------------------------------------------------------- components


@pytest.mark.parametrize("voxel_size", [(1.0, 1.0, 1.0), (0.9, 0.9, 5.0), (4.0, 1.0, 1.0)])
def test_component_filtering_exact(voxel_size):
    _, _, l1, _, _ = chip_smoke.synthetic_cohort((20, 24, 18), 1, seed=3)
    m = l1[0] * _mask(l1[0].shape, 11, frac=0.85)
    want = _np(jcomp.component_filtering(jnp.asarray(m), voxel_size))
    got = _np(components.component_filtering(_t(m), voxel_size))
    np.testing.assert_array_equal(got, want)
    if max(voxel_size) / min(voxel_size) > 3.0:
        # the unfiltered orientations enter the union whole, as in JAX
        np.testing.assert_array_equal(got, m)
    else:
        assert 0 < got.sum() < m.sum()


def test_average_contiguous_labels_ties_to_lowest_id():
    rng = np.random.RandomState(12)
    stack = rng.randint(0, 4, size=(4, 8, 9, 7)).astype(np.float32)
    stack[:, 0, 0, 0] = [3, 1, 3, 1]  # a tie between 1 and 3 -> 1
    stack[:, 0, 0, 1] = [2, 0, 0, 2]  # a tie between 0 and 2 -> 0
    want = _np(jcomp.average_contiguous_labels(jnp.asarray(stack), 4))
    got = _np(components.average_contiguous_labels(_t(stack), 4))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 1 and got[0, 0, 1] == 0


def test_map_label_matches_jax():
    lbl = np.random.RandomState(13).randint(0, 5, size=(6, 7, 5)).astype(np.float32)
    np.testing.assert_array_equal(components.map_label(lbl, [1, 3, 4], [2, 1, 9]),
                                  jcomp.map_label(lbl, [1, 3, 4], [2, 1, 9]))


# ---------------------------------------------------------------- filters


def _signed(shape, seed):
    """Negative values and both zeros, as stage-1's masked anomaly has."""
    v = _volume(shape, seed)
    v[np.random.RandomState(seed + 1).rand(*shape) < 0.3] = 0.0
    v[np.random.RandomState(seed + 2).rand(*shape) < 0.15] = -0.0
    return v


@pytest.mark.parametrize("size", [3, (1, 3, 5), 6, (2, 1, 4)])
def test_median_filter_exact(size):
    """Rank n//2 of the window, the upper middle for an even n (scipy's
    rank filter; torch.median would take the lower)."""
    v = _signed((9, 11, 10), 14)
    want = _np(jfilt.median_filter(jnp.asarray(v), size))
    got = _np(filters.median_filter(_t(v), size))
    np.testing.assert_array_equal(got, want)
    if size == 6:
        v = _volume((9, 11, 10), 14)
        upper = filters.median_filter(_t(v), size).numpy()
        lower = filters.window_stack(_t(v), size).median(0).values.numpy()
        np.testing.assert_array_equal(upper, _np(jfilt.median_filter(jnp.asarray(v), size)))
        assert (lower != upper).mean() > 0.05


def test_median_filter_slabs_equal_one_stack():
    v = _signed((13, 8, 9), 15)
    whole = filters.median_filter(_t(v), (3, 3, 5))
    slabs = filters.median_filter(_t(v), (3, 3, 5), max_stack_bytes=45 * 8 * 9 * 4 * 3)
    assert torch.equal(whole, slabs)
    np.testing.assert_array_equal(
        _np(slabs), _np(jfilt.median_filter(jnp.asarray(v), (3, 3, 5), max_stack_bytes=4000)))


@pytest.mark.parametrize("name", ["min_filter", "max_filter", "mean_filter"])
@pytest.mark.parametrize("size", [3, (2, 3, 4)])
def test_min_max_mean_filters_match_jax(name, size):
    v = _signed((8, 9, 10), 16)
    want = _np(getattr(jfilt, name)(jnp.asarray(v), size))
    got = _np(getattr(filters, name)(_t(v), size))
    _close(got, want)


@pytest.mark.parametrize("voxel_size", [(1.0, 1.0, 1.0), (2.0, 2.0, 2.0), (0.5, 0.5, 0.5),
                                        (1.0, 1.0, 5.0), (0.45, 0.9, 4.0)])
def test_median_3mm_exact(voxel_size):
    v = _signed((10, 12, 9), 17)
    want = _np(jfilt.median_3mm(jnp.asarray(v), voxel_size))
    got = _np(filters.median_3mm(_t(v), voxel_size))
    np.testing.assert_array_equal(got, want)


def test_median3_reference_matches_pallas_interpret():
    v = _signed((6, 16, 16), 18)
    got = kernels.median3_reference(_t(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(median3_pallas(jnp.asarray(v), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jfilt.median_filter(jnp.asarray(v), 3)))


def test_median3_wrapper_takes_plain_version_on_cpu():
    v = _t(_signed((5, 6, 7), 19))
    before = kernels.median3.launches
    assert torch.equal(kernels.median3(v), kernels.median3_reference(v))
    assert torch.equal(filters.median_filter(v, 3), kernels.median3_reference(v))
    assert kernels.median3.launches == before  # nothing launched
    assert kernels.median3(torch.zeros(1, 1, 1)).shape == (1, 1, 1)
    for bad in (v.double(), v[0], torch.zeros(0, 2, 2)):
        with pytest.raises(ValueError):
            kernels.median3(bad)


def test_median27_op_count():
    # 351 compare-exchanges in _median27's network; 520 min/max of them
    # reach rank 13
    assert kernels.median27_minmax_ops() == 520


def test_median27_shared_op_count():
    # per z-plane two column sorts (3 exchanges each) and a 9-way merge (18
    # exchanges); per pair of outputs one 9 + 9 merge pruned to ranks 4..13
    # (48 of its 60 min/max); per output a select of 9 mins and 9 maxes
    ops = kernels.median27_shared_ops()
    assert (ops["column"], ops["slab"], ops["pair"], ops["select"]) == (6, 36, 48, 18)
    assert ops["per_output"] == 90 < kernels.median27_minmax_ops()


def _ce_bits(w, i, j):
    # a compare-exchange on 0/1 values: min is AND, max is OR
    w[i], w[j] = w[i] & w[j], w[i] | w[j]


def _median27_fails(column=kernels.MEDIAN27_COLUMN, slab=kernels.MEDIAN27_SLAB,
                    pair=kernels.MEDIAN27_PAIR, chunk_bits=21):
    """K2's scheme on every 0/1 input of its 27 wires, 64 inputs to a uint64
    word: columns sorted, slabs merged, slabs 0 and 1 paired, selected
    against slab 2. By the 0-1 principle (min/max networks commute with
    every threshold) it selects rank 13 of any input iff it does so on
    each of the 2^27 0/1 inputs, where rank 13 is 1 iff 14 or more inputs
    are 1. Returns the first failing block of 2^chunk_bits inputs, or None."""
    n_in, words = 27, 1 << (chunk_bits - 6)
    ones, zero = np.uint64(2**64 - 1), np.uint64(0)
    word_idx = np.arange(words, dtype=np.uint64)
    # wire i < 6 alternates inside a word; wires below chunk_bits follow the
    # word index; the others are constant within a block
    in_word = [np.uint64(sum(1 << b for b in range(64) if (b >> i) & 1)) for i in range(6)]
    by_word = [np.where((word_idx >> np.uint64(i - 6)) & np.uint64(1), ones, zero)
               for i in range(6, chunk_bits)]
    local = np.arange(1 << chunk_bits, dtype=np.uint32)
    local_ones = sum(((local >> i) & 1).astype(np.uint8) for i in range(chunk_bits))
    for block in range(1 << (n_in - chunk_bits)):
        wire = [np.full(words, v, np.uint64) for v in in_word] + by_word + [
            np.full(words, ones if (block >> (i - chunk_bits)) & 1 else zero, np.uint64)
            for i in range(chunk_bits, n_in)]
        slabs = []
        for dz in range(3):
            cols = []
            for dx in range(3):
                col = [wire[dz * 9 + dy * 3 + dx] for dy in range(3)]
                for i, j in column:
                    _ce_bits(col, i, j)
                cols += col
            for i, j in slab:
                _ce_bits(cols, i, j)
            slabs.append([cols[i] for i in kernels.MEDIAN27_SLAB_ORDER])
        w = slabs[0] + slabs[1]
        for i, j in pair:
            _ce_bits(w, i, j)
        p = {r: w[kernels.MEDIAN27_PAIR_ORDER[r]] for r in kernels.MEDIAN27_PAIR_RANKS}
        got = p[kernels.MEDIAN27_SELECT_FLOOR]
        for i, j in kernels.MEDIAN27_SELECT_TERMS:
            got = got | (p[i] & slabs[2][j])
        want = np.packbits(local_ones + bin(block).count("1") >= 14,
                           bitorder="little").view(np.uint64)
        if not np.array_equal(got, want):
            return block
    return None


def test_median27_scheme_selects_rank_13_on_every_01_input():
    assert _median27_fails() is None


@pytest.mark.parametrize("stage,k", [("column", 0), ("column", 2), ("slab", 0), ("slab", 9),
                                     ("pair", 0), ("pair", 15), ("pair", 28)])
def test_median27_proof_catches_a_broken_network(stage, k):
    # the proof has teeth: without one live exchange the scheme fails (the
    # pair's last exchange only orders ranks 16 and 17, which nothing reads)
    ces = getattr(kernels, "MEDIAN27_" + stage.upper())
    assert _median27_fails(**{stage: ces[:k] + ces[k + 1:]}) is not None


def test_median27_header_is_generated_from_the_lists():
    with open(os.path.join(kernels.CSRC_DIR, "median27_network.h")) as f:
        assert f.read() == kernels.median27_header()


@pytest.mark.parametrize("seed", [0, 1])
def test_median27_scheme_on_signed_values(seed):
    # the same composition on f32 windows (negatives, +-0.0, ties) against
    # torch's rank 13, value for value
    rng = np.random.RandomState(seed)
    v = rng.randn(4096, 27).astype(np.float32)
    v[rng.rand(*v.shape) < 0.3] = 0.0
    v[rng.rand(*v.shape) < 0.15] = -0.0
    v[:, rng.randint(27)] = v[:, rng.randint(27)]
    w = [torch.from_numpy(v[:, k]) for k in range(27)]

    def ce(a, i, j):
        a[i], a[j] = torch.minimum(a[i], a[j]), torch.maximum(a[i], a[j])

    slabs = []
    for dz in range(3):
        cols = []
        for dx in range(3):
            col = [w[dz * 9 + dy * 3 + dx] for dy in range(3)]
            for i, j in kernels.MEDIAN27_COLUMN:
                ce(col, i, j)
            cols += col
        for i, j in kernels.MEDIAN27_SLAB:
            ce(cols, i, j)
        slabs.append([cols[i] for i in kernels.MEDIAN27_SLAB_ORDER])
    pw = slabs[0] + slabs[1]
    for i, j in kernels.MEDIAN27_PAIR:
        ce(pw, i, j)
    p = {r: pw[kernels.MEDIAN27_PAIR_ORDER[r]] for r in kernels.MEDIAN27_PAIR_RANKS}
    got = p[kernels.MEDIAN27_SELECT_FLOOR]
    for i, j in kernels.MEDIAN27_SELECT_TERMS:
        got = torch.maximum(got, torch.minimum(p[i], slabs[2][j]))
    assert torch.equal(got, torch.sort(torch.from_numpy(v), dim=1).values[:, 13])


# ---------------------------------------------------------------- the core


def _core(pkg, cohort, spacing, debug=False):
    x, refs, l1, l2, _ = cohort
    kw = dict(patch_size=analysis.patch_size_from_voxel(spacing), voxel_size=spacing,
              num_label_classes=int(l2.max()) + 1, debug=debug)
    if pkg is janalysis:
        return [np.asarray(o) if not isinstance(o, dict) else {k: np.asarray(v) for k, v in o.items()}
                for o in janalysis.nll_analysis_core(*map(jnp.asarray, (x, refs, l1, l2)), **kw)]
    return [_np(o) if not isinstance(o, dict) else {k: _np(v) for k, v in o.items()}
            for o in analysis.nll_analysis_core(*map(_t, (x, refs, l1, l2)), **kw)]


def _check_core(got, want):
    an_g, an_w = got[0], want[0]
    print("core: anomaly gap %.2e of max %.1f, threshold %r vs %r, valid mask %.6f equal"
          % (np.abs(an_g - an_w).max() / np.abs(an_w).max(), np.abs(an_w).max(),
             float(got[8]), float(want[8]), (got[1] == want[1]).mean()))
    assert np.abs(an_g - an_w).max() <= ANOMALY_TOL * np.abs(an_w).max()
    for i in (1,):  # valid mask
        assert (got[i] == want[i]).mean() >= MASK_AGREEMENT
    np.testing.assert_array_equal(got[3], want[3])  # averaged label
    _close(got[2], want[2])  # normalised input
    _close(got[4], want[4], rtol=1e-5)  # bin centres
    bin_w = float(want[4][1] - want[4][0])
    assert abs(float(got[8]) - float(want[8])) <= bin_w * 1.0001
    seg_g, seg_w = an_g > float(got[8]), an_w > float(want[8])
    assert (seg_g == seg_w).mean() >= MASK_AGREEMENT


def test_nll_analysis_core_matches_jax():
    cohort = chip_smoke.synthetic_cohort(SLICE_SHAPE, SLICE_K, seed=0)
    got = _core(analysis, cohort, SLICE_SPACING, debug=True)
    want = _core(janalysis, cohort, SLICE_SPACING, debug=True)
    _check_core(got[:-1], want[:-1])
    # the median branch runs: the class-2 region holds a lesion
    l2 = cohort[3]
    assert (cohort[4] * (got[3] == 2)).sum() > 0 and ((l2 == 2).sum(0) > 0).any()
    dbg_g, dbg_w = got[-1], want[-1]
    assert set(dbg_g) == set(dbg_w)
    for key in dbg_w:
        g, w = dbg_g[key], dbg_w[key]
        assert g.shape == w.shape, key
        assert (np.isnan(g) == np.isnan(w)).mean() >= MASK_AGREEMENT, key
        both = np.isfinite(g) & np.isfinite(w)
        scale = max(np.abs(w[both]).max(), 1.0)
        assert np.abs(g[both] - w[both]).max() <= ANOMALY_TOL * scale, key


# one package's stage-1 core in f64 on synthetic_cohort((24, 20, 22), 3,
# seed 0): every f32 of the package made f64 in a process of its own
F64_CORE = """
import sys
sys.path[:0] = [%(repo)r, %(tests)r]
import numpy as np
import chip_smoke
which, spacing, out = sys.argv[1], (float(sys.argv[2]),) * 3, sys.argv[3]
x, refs, l1, l2, _ = chip_smoke.synthetic_cohort((24, 20, 22), 3, seed=0)
ins = [a.astype(np.float64) for a in (x, refs, l1, l2)]
if which == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    jnp.float32 = jnp.float64
    from deepwmh_tpu.pipeline import analysis as A
    up, down = jnp.asarray, np.asarray
else:
    import torch
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.float32 = torch.float64
    from deepwmh_tpu_torch.pipeline import analysis as A
    up, down = torch.from_numpy, lambda t: t.numpy()
anomaly = down(A.nll_analysis_core(
    *map(up, ins), patch_size=A.patch_size_from_voxel(spacing), voxel_size=spacing,
    num_label_classes=int(l2.max()) + 1)[0])
assert anomaly.dtype == np.float64, anomaly.dtype
np.save(out, anomaly)
"""


@pytest.mark.slow
def test_stage1_one_mm_f32_witness(tmp_path):
    """At 1 mm, the flagship spacing, the per-case core on 24x20x22 (K = 3,
    seed 0) leaves JAX's by 2.3e-4 of max |anomaly|, above the 1e-4 bar.
    Both packages rerun in f64 agree within 1e-12 of max |anomaly| (one
    algorithm), and the f32 runs held against that: the port's within the
    bar, JAX's beyond it, so the gap is the reference's f32 error, not the
    port's (ROADMAP.md C7)."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "f64_core.py"
    script.write_text(F64_CORE % {"repo": os.path.dirname(here), "tests": here})
    truth = {}
    for which in ("jax", "port"):
        out = str(tmp_path / (which + ".npy"))
        subprocess.run([sys.executable, str(script), which, "1.0", out], check=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        truth[which] = np.load(out)
    scale = np.abs(truth["jax"]).max()
    agree = np.abs(truth["jax"] - truth["port"]).max() / scale
    assert agree <= 1e-12
    cohort = chip_smoke.synthetic_cohort((24, 20, 22), 3, seed=0)
    got = _core(analysis, cohort, (1.0, 1.0, 1.0), debug=True)
    want = _core(janalysis, cohort, (1.0, 1.0, 1.0))[0]
    std, got = got[-1]["std_value"], got[0]
    err = {k: float(np.abs(a - truth["jax"]).max() / scale)
           for k, a in (("port", got), ("jax", want))}
    at = np.unravel_index(np.abs(got - want).argmax(), got.shape)
    print("1 mm: |f32 - f64| of max |anomaly|: port %.3e, JAX %.3e; port - JAX %.3e, at %s "
          "(references' std %.5f); the f64 runs within %.1e"
          % (err["port"], err["jax"], np.abs(got - want).max() / scale, at, std[at], agree))
    assert err["port"] <= ANOMALY_TOL < err["jax"]


def test_nll_analysis_core_stage_times():
    cohort = chip_smoke.synthetic_cohort((24, 28, 20), 3, seed=1)
    x, refs, l1, l2, _ = map(_t, cohort)
    stage_s = {}
    plain = analysis.nll_analysis_core(x, refs, l1, l2, (25, 25, 25), SLICE_SPACING, 4)
    timed = analysis.nll_analysis_core(x, refs, l1, l2, (25, 25, 25), SLICE_SPACING, 4,
                                       stage_s=stage_s)
    assert set(stage_s) == {"mask_zscore_otsu", "local_mean_alignment", "nll",
                            "component_filtering", "histogram_threshold", "tissue_vote",
                            "median_3mm"}
    for a, b in zip(plain, timed):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the whole slice

ARTIFACTS = ("anomaly_score", "valid_mask", "normalized_input", "averaged_label")


def _write_cohort(folder, seed=0, suffix=".nii.gz"):
    # the JAX package copies the target under a .nii.gz name as it is, so it
    # needs gzipped input; the port also takes plain .nii
    return chip_smoke.write_cohort(str(folder), SLICE_SHAPE, SLICE_SPACING, SLICE_K, seed,
                                   suffix=suffix)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1")
    cohort = _write_cohort(root / "data")
    *case, lesions = cohort
    jan = janalysis.LesionAnalyzer(str(root / "jax"))
    jan.add_case("case1", *case)
    jan.analyze_and_do_segmentation(intensity_prior="+")
    port = analysis.LesionAnalyzer(str(root / "port"), device="cpu")
    port.add_case("case1", *case)
    port.analyze_and_do_segmentation(intensity_prior="+")
    return root, case, lesions


def _load(out, case, name):
    return nifti.load_nifti(os.path.join(out, case, name))


def test_lesion_analyzer_matches_jax(slice_runs):
    root, _, lesions = slice_runs
    out_j, out_p = str(root / "jax"), str(root / "port")
    with open(os.path.join(out_j, "case1", "summary.json")) as f:
        sj = json.load(f)
    with open(os.path.join(out_p, "case1", "summary.json")) as f:
        sp = json.load(f)
    assert set(sp) == set(sj) and sp["intensity_prior"] == sj["intensity_prior"]
    xs = np.asarray(sj["histogram_curves"]["x"])
    assert abs(sp["autoseg_threshold"] - sj["autoseg_threshold"]) <= (xs[1] - xs[0]) * 1.0001
    for key in ("x", "y", "r"):
        g, w = np.asarray(sp["histogram_curves"][key]), np.asarray(sj["histogram_curves"][key])
        assert g.shape == w.shape == (400,)
        # the x grid moves by ulps; a curve bin by a count or so where an
        # edge moves, and elsewhere by the 1-2 ulps of two libms' log10
        assert np.abs(g - w).max() <= (1e-5 * np.abs(w).max() if key == "x" else 0.5)
        if key != "x":
            assert np.isclose(g, w, rtol=2.5e-7, atol=0).mean() > 0.99
    for name in ARTIFACTS:
        (g, hg), (w, hw) = _load(out_p, "case1", name + ".nii.gz"), _load(out_j, "case1", name + ".nii.gz")
        assert g.shape == w.shape == SLICE_SHAPE and tuple(hg.zooms[:3]) == SLICE_SPACING
        assert np.isfinite(g).all()
        if name == "anomaly_score":
            assert np.abs(g - w).max() <= ANOMALY_TOL * np.abs(w).max()
        elif name == "normalized_input":
            _close(g, w)
        elif name == "valid_mask":
            assert (g == w).mean() >= MASK_AGREEMENT
        else:
            np.testing.assert_array_equal(g, w)
    for name in ("segmentation.nii.gz", "segmentation_pp.nii.gz"):
        g, w = _load(out_p, "case1", name)[0], _load(out_j, "case1", name)[0]
        assert (g == w).mean() >= MASK_AGREEMENT
    pp = _load(out_p, "case1", "segmentation_pp.nii.gz")[0] > 0.5
    seg = _load(out_p, "case1", "segmentation.nii.gz")[0] > 0.5
    assert not (pp & ~seg).any()
    dice = 2 * (pp & (lesions > 0.5)).sum() / max(pp.sum() + (lesions > 0.5).sum(), 1)
    assert dice > 0.5, "lesions not found (dice %.3f)" % dice
    with open(os.path.join(out_p, "case1", "segmentation.txt")) as f, \
            open(os.path.join(out_j, "case1", "segmentation.txt")) as g:
        txt_p, txt_j = f.read(), g.read()
    assert txt_p == "case name: case1\nsegmentation threshold: %.4f\n" % sp["autoseg_threshold"]
    if "%.4f" % sp["autoseg_threshold"] == "%.4f" % sj["autoseg_threshold"]:
        assert txt_p == txt_j


def test_lesion_analyzer_rerun_keeps_artifacts(slice_runs):
    root, case, _ = slice_runs
    out = str(root / "port")
    paths = [os.path.join(out, "case1", n) for n in
             ("anomaly_score.nii.gz", "summary.json", "segmentation.nii.gz",
              "segmentation_pp.nii.gz")]
    before = [os.path.getmtime(p) for p in paths]
    port = analysis.LesionAnalyzer(out, device="cpu")
    port.add_case("case1", *case)
    port.analyze_and_do_segmentation(intensity_prior="+")
    assert [os.path.getmtime(p) for p in paths] == before
    # a deleted segmentation is recomputed from the artifacts
    seg = nifti.load_nifti_simple(paths[2])
    os.remove(paths[2])
    port.analyze_and_do_segmentation(intensity_prior="+")
    np.testing.assert_array_equal(nifti.load_nifti_simple(paths[2]), seg)
    assert os.path.getmtime(paths[0]) == before[0]


def test_lesion_analyzer_debug_writes_intermediates(tmp_path, slice_runs):
    root, case, _ = slice_runs
    port = analysis.LesionAnalyzer(str(tmp_path / "dbg"), device="cpu")
    port.add_case("caseD", *case)
    port.analyze_and_do_segmentation(intensity_prior="+", debug=True)
    case_dir = tmp_path / "dbg" / "caseD"
    for key in ("intensity_thr", "rough_brain", "local_mean", "mean_value", "std_value"):
        assert nifti.try_load_nifti(str(case_dir / (key + ".nii.gz"))), key
    for k in range(SLICE_K):
        assert nifti.try_load_nifti(str(case_dir / "references" / ("ref%02d.nii.gz" % k)))
        assert nifti.try_load_nifti(str(case_dir / "references" / ("ref%02d_anomaly.nii.gz" % k)))
    # debug changes no artifact of the plain run
    for name in ARTIFACTS:
        np.testing.assert_array_equal(
            nifti.load_nifti_simple(str(case_dir / (name + ".nii.gz"))),
            nifti.load_nifti_simple(os.path.join(str(root / "port"), "case1", name + ".nii.gz")))


def test_lesion_analyzer_batch_cases_give_per_case_outputs(tmp_path):
    cases = [("case%d" % i,) + tuple(_write_cohort(tmp_path / ("c%d" % i), seed=20 + i,
                                                   suffix=".nii")[:4])
             for i in range(3)]
    outs = {}
    for b in (1, 3):
        out = str(tmp_path / ("b%d" % b))
        port = analysis.LesionAnalyzer(out, device="cpu")
        for c in cases:
            port.add_case(*c)
        port.analyze_and_do_segmentation(batch_cases=b)
        outs[b] = out
    for name, *_ in cases:
        for art in ARTIFACTS + ("segmentation", "segmentation_pp"):
            np.testing.assert_array_equal(
                nifti.load_nifti_simple(os.path.join(outs[1], name, art + ".nii.gz")),
                nifti.load_nifti_simple(os.path.join(outs[3], name, art + ".nii.gz")))
        with open(os.path.join(outs[1], name, "summary.json")) as f, \
                open(os.path.join(outs[3], name, "summary.json")) as g:
            assert json.load(f)["autoseg_threshold"] == json.load(g)["autoseg_threshold"]


def test_lesion_analyzer_refuses_cpu_fallback_and_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis.LesionAnalyzer(str(tmp_path / "a"))
    port = analysis.LesionAnalyzer(str(tmp_path / "b"), device="cpu")
    # stage-1 over a mesh is ported: what is not a Mesh is refused
    with pytest.raises(TypeError, match="Mesh"):
        port.analyze_and_do_segmentation(mesh=object())
    with pytest.raises(ValueError, match="batch_cases"):
        port.analyze_and_do_segmentation(batch_cases="two")
