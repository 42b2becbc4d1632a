"""Batches against the JAX package on the CPU: B same-geometry pairs
through one Adam loop a level (JAX: ``vmap`` of the pair core), the batched
similarity reductions, ``register_affine_batch`` / ``register_svf_batch``
and ``launch(batch_pairs=)``; then stage-1 over a batch of cases
(``nll_analysis_batch``, the analyzer's ``batch_cases``) and K2's plain
version over a batch of volumes.

A batch of pairs gives other last bits than one pair (its products sum in
another order), and whole pairs amplify a last-bit change (``tests/
test_torch_port_group.py``), so rows are held on short schedules at the
one-pair bars, against JAX's vmapped row and the port's own one-pair run.
Stage-1 rows are held at the stage-1 bars against JAX's batch
(``tests/test_torch_port_analysis.py``) and, on the CPU at one thread, to
the per-case core's bits.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from deepwmh_tpu.pipeline import analysis as janalysis
from deepwmh_tpu.registration import affine as jaffine
from deepwmh_tpu.registration import group as jgroup
from deepwmh_tpu.registration import svf as jsvf
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.ops import kernels
from deepwmh_tpu_torch.parallel.mesh import Mesh
from deepwmh_tpu_torch.pipeline import analysis
from deepwmh_tpu_torch.registration import affine, group, svf
from test_torch_port_analysis import _check_core
from test_torch_port_group import (  # noqa: F401 (the fixtures register by name)
    SHAPE,
    T,
    _one_pair_bars,
    _short_cfgs,
    cohort,
    one_torch_thread,
)

BATCH_PAIRS = (("tgt0", "src0"), ("tgt0", "src1"), ("tgt1", "src0"))


def _stack(cases, pairs):
    """f16 fixed and moving stacks [B, D, H, W], as uploaded."""
    load = lambda c: nifti.load_nifti_simple(cases[c][0]).astype(np.float16)
    return np.stack([load(t) for t, _ in pairs]), np.stack([load(s) for _, s in pairs])


@pytest.fixture(scope="module")
def jax_batch(cohort):
    """JAX's vmapped pair core on the three pairs (one compile: its rows do
    not depend on the batch they are in)."""
    _, _, cases = cohort
    fixed, moving = _stack(cases, BATCH_PAIRS)
    jacfg, jscfg = _short_cfgs((jaffine, jsvf))
    sp = jnp.ones(3, jnp.float32)
    return [np.asarray(o) for o in jgroup._pair_core_batch_jit(
        jnp.asarray(fixed), jnp.asarray(moving), sp, sp, jacfg, jscfg, deformable=True)]


@pytest.mark.parametrize("B", [2, 3])
def test_pair_core_batch_matches_jax_and_one_pair(cohort, jax_batch, B):
    _, _, cases = cohort
    fixed, moving = _stack(cases, BATCH_PAIRS[:B])
    acfg, scfg = _short_cfgs((affine, svf))
    sp = np.ones(3, np.float32)
    want = [w[:B] for w in jax_batch]
    got = group._to_host(group._pair_core_batch(torch.from_numpy(fixed), torch.from_numpy(moving),
                                                T(sp), T(sp), acfg, scfg, True))
    assert [np.shape(g) for g in got] == [(B, 3, 4), (B,), (B, 3) + SHAPE, (B,), (B,) + SHAPE]
    assert got[2].dtype == np.float16 and got[4].dtype == np.float16
    for i in range(B):
        row = tuple(g[i] for g in got)
        span = fixed[i].astype(np.float32)
        _one_pair_bars(row, tuple(np.asarray(w)[i] for w in want), span)
        one = group._to_host(group._pair_core(torch.from_numpy(fixed[i]),
                                              torch.from_numpy(moving[i]), T(sp), T(sp), acfg,
                                              scfg, True))
        _one_pair_bars(row, one, span)
        assert abs(row[1] - one[1]) <= 1e-4 and abs(row[3] - one[3]) <= 1e-4


def test_pair_core_batch_refuses_what_is_not_a_batch():
    a, b = torch.zeros(2, 16, 16, 16), torch.zeros(3, 16, 16, 12)
    cfgs = _short_cfgs((affine, svf))
    for f, m in ((a, b), (a[0], a[0]), (a, b[0])):
        with pytest.raises(ValueError, match="stacks"):
            group._pair_core_batch(f, m, T(np.ones(3)), T(np.ones(3)), *cfgs, True)


def test_similarity_ops_reduce_pair_by_pair():
    """Each pair's quantiles (bit for bit), MI, LNCC, smoothness and centre
    of mass in a batch are its own, where a batch-wide reduction would mix
    pairs of different ranges."""
    from deepwmh_tpu_torch.registration import similarity as sim

    rs = np.random.RandomState(3)
    vols = T(rs.rand(3, 12, 10, 14) * np.array([1.0, 50.0, 400.0])[:, None, None, None])
    other = T(rs.rand(3, 12, 10, 14))
    w = sim.winsorize_rescale(vols)
    for b in range(3):
        assert torch.equal(w[b], sim.winsorize_rescale(vols[b]))
    o = sim.winsorize_rescale(other)
    field = T(rs.randn(3, 3, 12, 10, 14))
    sp = affine.spacing_tensor((1.0, 2.0, 0.5), "cpu")
    got = {"mi": sim.mutual_information(w, o, batch=True), "lncc": sim.lncc(w, o, radius=2),
           "grad_sq": sim.grad_sq(field), "com": affine._center_of_mass(vols, sp),
           "mi_strided": sim.mutual_information(w.reshape(3, -1)[:, ::4], o.reshape(3, -1)[:, ::4],
                                                batch=True)}
    for b in range(3):
        want = {"mi": sim.mutual_information(w[b], o[b]), "lncc": sim.lncc(w[b], o[b], radius=2),
                "grad_sq": sim.grad_sq(field[b]), "com": affine._center_of_mass(vols[b], sp),
                "mi_strided": sim.mutual_information(w[b].reshape(-1)[::4], o[b].reshape(-1)[::4])}
        for k in want:
            np.testing.assert_allclose(got[k][b].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)


def test_batch_reads_one_pairs_size_for_the_mi_stride(monkeypatch):
    """At 32^3 the shrink-2 level of one pair holds 4096 voxels, fewer than
    4096 * stride, so it samples every voxel, and the full level takes
    stride 4; a batch of 4 (16384 voxels at shrink 2) must do the same."""
    seen = []
    real = affine._optimize_level
    monkeypatch.setattr(affine, "_optimize_level",
                        lambda *a, **kw: seen.append(kw["sample_stride"]) or real(*a, **kw))
    vols = np.random.RandomState(0).rand(2, 4, 32, 32, 32).astype(np.float32)
    cfg = affine.AffineConfig(shrinks=(2, 1), iters=(1, 1), do_affine=False)
    mats, losses = affine.register_affine_batch(vols[0], vols[1], cfg=cfg, device="cpu")
    assert seen == [1, 4] and mats.shape == (4, 3, 4) and losses.shape == (4,)


def test_register_affine_and_svf_batch_match_jax(cohort):
    """``register_affine_batch`` / ``register_svf_batch`` (short schedules)
    row by row against JAX's vmapped functions and the one-pair calls."""
    _, _, cases = cohort
    fixed, moving = (a.astype(np.float32) for a in _stack(cases, BATCH_PAIRS[:2]))
    kw = dict(shrinks=(4,), iters=(1,))
    mats, losses = affine.register_affine_batch(fixed, moving, cfg=affine.AffineConfig(**kw),
                                                device="cpu")
    jmats, jlosses = jaffine.register_affine_batch(fixed, moving, cfg=jaffine.AffineConfig(**kw))
    assert mats.shape == (2, 3, 4) and losses.shape == (2,)
    np.testing.assert_allclose(mats, jmats, atol=2e-3)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    skw = dict(shrinks=(4,), iters=(3,), lncc_radius=2)
    disps, slosses = svf.register_svf_batch(fixed, moving, cfg=svf.SVFConfig(**skw), device="cpu")
    jdisps, jslosses = jsvf.register_svf_batch(fixed, moving, cfg=jsvf.SVFConfig(**skw))
    assert disps.shape == (2, 3) + SHAPE and slosses.shape == (2,)
    assert np.abs(disps - jdisps).max() <= 0.05
    np.testing.assert_allclose(slosses, jslosses, atol=1e-4)
    for i in range(2):
        m1, _ = affine.register_affine(fixed[i], moving[i], cfg=affine.AffineConfig(**kw),
                                       device="cpu")
        np.testing.assert_allclose(mats[i], m1, atol=2e-3)
        d1, _ = svf.register_svf(fixed[i], moving[i], cfg=svf.SVFConfig(**skw), device="cpu")
        assert np.abs(disps[i] - d1).max() <= 0.05


def test_launch_batches_same_geometry_pairs(cohort, tmp_path, monkeypatch):
    """launch(batch_pairs=3) over 2 sources x 3 targets, one target of
    another geometry: two buckets, chunks of 3 and 1 of the first (a batch
    and one pair) and 2 of the second; one artifact set a pair, within the
    one-pair bars of launch(batch_pairs=1)'s; a re-run registers nothing."""
    _, _, cases = cohort
    vol, hdr = nifti.load_nifti(cases["tgt1"][0])
    odd = str(tmp_path / "odd.nii.gz")
    hdr.set_shape((32, 32, 28))
    nifti.save_nifti(np.ascontiguousarray(vol[:, :, 2:30]), hdr, odd)
    sources = [(c, cases[c][0]) for c in ("src0", "src1")]
    targets = [("tgt0", cases["tgt0"][0]), ("tgt1", cases["tgt1"][0]), ("odd", odd)]
    calls = []

    def counted(name, real):
        def run(f, *a, **kw):
            # the batch runs the one-pair code on its stacks: count only
            # the calls the launcher makes
            if name == "_pair_core_batch" or f.dim() == 3:
                calls.append((name, tuple(f.shape)))
            return real(f, *a, **kw)
        return run

    for name in ("_pair_core", "_pair_core_batch"):
        monkeypatch.setattr(group, name, counted(name, getattr(group, name)))
    outs = {}
    for b in (3, 1):
        reg = group.GroupRegistration(sources, targets, str(tmp_path / ("b%d" % b)), quick=True,
                                      device="cpu")
        reg.affine_cfg, reg.svf_cfg = _short_cfgs((affine, svf))
        del calls[:]
        reg.launch(verbose=False, batch_pairs=b)
        outs[b] = (reg, list(calls))
    assert outs[3][1] == [("_pair_core_batch", (3,) + SHAPE), ("_pair_core", SHAPE),
                          ("_pair_core_batch", (2, 32, 32, 28))]
    assert [c[0] for c in outs[1][1]] == ["_pair_core"] * 6
    for s, _ in sources:
        for t, t_path in targets:
            pair = group.pair_name(s, t)
            got, want = ([], [])
            for b, into in ((3, got), (1, want)):
                d = os.path.join(str(tmp_path / ("b%d" % b)), pair)
                with open(os.path.join(d, "affine.json")) as f:
                    meta = json.load(f)
                into += [np.asarray(meta["matrix"]), meta["affine_loss"],
                         np.moveaxis(nifti.load_nifti_simple(os.path.join(d, "warp.nii.gz")),
                                     -1, 0), meta["svf_loss"],
                         nifti.load_nifti_simple(d + ".nii.gz")]
            _one_pair_bars(got, want, nifti.load_nifti_simple(t_path))
    stamps = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(str(tmp_path / "b3")) for f in fs}
    del calls[:]
    outs[3][0].launch(verbose=False, batch_pairs=3)
    assert calls == [] and stamps == {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
                                      for d, _, fs in os.walk(str(tmp_path / "b3")) for f in fs}


# -------------------------------------------------- stage-1 over a case batch


def _case_pair(shape, K=3):
    """Two seeded cases; the second's target scaled and offset, so that its
    z-scores, minima and bins differ from the first's (a batch-wide min or
    moment would show)."""
    c0 = chip_smoke.synthetic_cohort(shape, K, seed=0)
    c1 = chip_smoke.synthetic_cohort(shape, K, seed=1)
    return c0, (c1[0] * 3.0 + 500.0,) + tuple(c1[1:])


def _stage1_kw(spacing, cases):
    return dict(patch_size=analysis.patch_size_from_voxel(spacing), voxel_size=spacing,
                num_label_classes=max(int(c[3].max()) for c in cases) + 1)


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 20, 22)])
def test_nll_analysis_batch_matches_jax_and_per_case(shape):
    """B = 2 at the stage-1 suite's 2 mm spacing: each row against JAX's
    batch at the stage-1 bars and bit-equal to the port's per-case core (at
    1 mm JAX's own f32 core strays from its f64 run beyond the 1e-4 bar:
    test_torch_port_analysis.py::test_stage1_one_mm_f32_witness, ROADMAP.md
    C7; the 1 mm batch is held against the per-case core below)."""
    spacing = (2.0, 2.0, 2.0)
    cases = _case_pair(shape)
    stacks = [np.stack([c[i] for c in cases]) for i in range(4)]
    kw = _stage1_kw(spacing, cases)
    got = [o.numpy() for o in analysis.nll_analysis_batch(*stacks, device="cpu", **kw)]
    want = [np.asarray(o) for o in janalysis.nll_analysis_batch(*map(jnp.asarray, stacks), **kw)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape == (2,) + shape and got[7].shape == (2, 3, 400) and got[8].shape == (2,)
    for b, case in enumerate(cases):
        _check_core([g[b] for g in got], [w[b] for w in want])
        one = analysis.nll_analysis_core(*(torch.from_numpy(np.ascontiguousarray(case[i]))
                                           for i in range(4)), **kw)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[b], o.numpy())
    with pytest.raises(ValueError, match="one geometry"):
        analysis.nll_analysis_batch(stacks[0], stacks[1][:, :2], stacks[2], stacks[3],
                                    device="cpu", **kw)


def test_nll_analysis_batch_at_one_mm_is_per_case():
    """B = 2 at 1 mm, the flagship spacing, on 24x20x22 (the witness's
    shape): every output of each row bit-equal to the per-case core."""
    spacing = (1.0, 1.0, 1.0)
    cases = _case_pair((24, 20, 22))
    kw = _stage1_kw(spacing, cases)
    got = analysis.nll_analysis_batch(*(np.stack([c[i] for c in cases]) for i in range(4)),
                                      device="cpu", **kw)
    for b, case in enumerate(cases):
        one = analysis.nll_analysis_core(*(torch.from_numpy(np.ascontiguousarray(case[i]))
                                           for i in range(4)), **kw)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[b].numpy(), o.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_nll_analysis_batch_over_a_mesh(n):
    """Three cases over n shards (padding by the last case): the batch's
    outputs without a mesh, the padding dropped."""
    shape, spacing = (16, 18, 16), (2.0, 2.0, 2.0)
    cases = list(_case_pair(shape)) + [chip_smoke.synthetic_cohort(shape, 3, seed=2)]
    stacks = [np.stack([c[i] for c in cases]) for i in range(4)]
    kw = _stage1_kw(spacing, cases)
    whole = analysis.nll_analysis_batch(*stacks, device="cpu", **kw)
    sharded = analysis.nll_analysis_batch(*stacks, mesh=Mesh(["cpu"] * n), **kw)
    for a, b in zip(whole, sharded):
        assert b.shape == a.shape and b.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(TypeError, match="Mesh"):
        analysis.nll_analysis_batch(*stacks, mesh=object(), **kw)


def test_analyzer_batch_cases_split_by_classes_and_resume(tmp_path, monkeypatch):
    """batch_cases=3 over three same-geometry cases, the third with one
    label class fewer: one batch of two and one case alone, the artifacts
    byte-equal to the one-case path's; a one-case run over the batched
    output analyses nothing."""
    cases = []
    for i in range(3):
        folder = str(tmp_path / ("c%d" % i))
        paths = chip_smoke.write_cohort(folder, (24, 28, 20), (2.0, 2.0, 2.0), 3, 40 + i,
                                        suffix=".nii")
        if i == 2:  # no ventricle class: num_label_classes 3 instead of 4
            for p in paths[3]:
                vol, hdr = nifti.load_nifti(p)
                nifti.save_nifti(np.where(vol == 3.0, 1.0, vol).astype(np.float32), hdr, p)
        cases.append(("case%d" % i,) + tuple(paths[:4]))
    batches = []
    real = analysis.nll_analysis_batch
    monkeypatch.setattr(analysis, "nll_analysis_batch",
                        lambda xs, *a, **kw: batches.append(
                            (len(xs), kw["num_label_classes"])) or real(xs, *a, **kw))
    outs = {}
    for b in (3, 1):
        out = str(tmp_path / ("b%d" % b))
        port = analysis.LesionAnalyzer(out, device="cpu")
        for c in cases:
            port.add_case(*c)
        port.analyze_and_do_segmentation(batch_cases=b)
        outs[b] = (out, port)
    assert batches == [(2, 4)]
    for name, *_ in cases:
        for art in ("anomaly_score", "valid_mask", "normalized_input", "averaged_label",
                    "segmentation", "segmentation_pp"):
            with open(os.path.join(outs[3][0], name, art + ".nii.gz"), "rb") as f, \
                    open(os.path.join(outs[1][0], name, art + ".nii.gz"), "rb") as g:
                assert f.read() == g.read(), (name, art)
        with open(os.path.join(outs[3][0], name, "summary.json")) as f, \
                open(os.path.join(outs[1][0], name, "summary.json")) as g:
            assert json.load(f)["histogram_curves"] == json.load(g)["histogram_curves"]
    monkeypatch.setattr(analysis.LesionAnalyzer, "analyze_case",
                        lambda *a, **kw: pytest.fail("a finished case was analysed again"))
    resumed = analysis.LesionAnalyzer(outs[3][0], device="cpu")
    for c in cases:
        resumed.add_case(*c)
    resumed.analyze_and_do_segmentation(batch_cases=1)
    assert batches == [(2, 4)]


@pytest.mark.parametrize("B", [1, 2, 3])
def test_median3_reference_takes_a_batch(B):
    """K2's plain version on [B, D, H, W] equals B single-volume calls: each
    volume keeps its own zero boundary (the volumes differ by large
    constants, so a plane read across the batch would show)."""
    g = torch.Generator().manual_seed(B)
    vols = torch.randn((B, 7, 9, 11), generator=g) + 1000.0 * torch.arange(B)[:, None, None, None]
    got = kernels.median3_reference(vols)
    assert got.shape == vols.shape
    for b in range(B):
        assert torch.equal(got[b], kernels.median3_reference(vols[b]))
    assert torch.equal(kernels.median3(vols), got)  # the wrapper on the CPU


@pytest.mark.parametrize("voxel_size", [(1.0, 1.0, 1.0), (0.5, 0.5, 0.5), (0.9, 0.9, 5.0)])
def test_median_3mm_takes_a_batch(voxel_size):
    """The 3 mm median of a batch (K2's 3x3x3, a 6x6x6 window, a 2-D
    kernel across the thick axis) equals each volume's own."""
    from deepwmh_tpu_torch.ops.filters import median_3mm

    g = torch.Generator().manual_seed(7)
    vols = torch.randn((2, 12, 10, 9), generator=g) + torch.tensor([0.0, 50.0])[:, None, None, None]
    got = median_3mm(vols, voxel_size)
    for b in range(2):
        assert torch.equal(got[b], median_3mm(vols[b], voxel_size))
