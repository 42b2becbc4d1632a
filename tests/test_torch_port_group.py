"""deepwmh_tpu_torch group registration against the JAX package on the CPU:
one pair through ``_pair_core``, the group CLI on a 2x2 cohort, artifacts
read across packages, the warm start, the policy, the priors and the priors
CLI. The same numpy inputs from a seed go through both packages.

Whole pairs with the registration presets are compared by what they
achieve, not value by value: at these sizes the presets keep one pyramid
level of 8^3 voxels, where MI and Adam's sign-like first steps make the
optimisation chaotic. JAX's own training-prep pair at 32^3 moves its
matrix by 0.80, its field by 0.50 voxel and its image by 8.6% of the range
when one voxel of the moving image moves by one f16 ulp (measured). Short
schedules, where the packages agree step by step, are compared at the
one-pair bars: matrix 2e-3, field 0.05 voxel, image 1e-2 of the range,
order-0 labels 99.5% equal.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from deepwmh_tpu.cli import group_register as jcli
from deepwmh_tpu.cli import priors as jpriors_cli
from deepwmh_tpu.core import nifti as jnifti
from deepwmh_tpu.registration import affine as jaffine
from deepwmh_tpu.registration import group as jgroup
from deepwmh_tpu.registration import policy as jpolicy
from deepwmh_tpu.registration import priors as jpriors
from deepwmh_tpu.registration import svf as jsvf
from deepwmh_tpu.registration import warm as jwarm
from deepwmh_tpu_torch.cli import group_register as cli
from deepwmh_tpu_torch.cli import priors as priors_cli
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.registration import affine, group, policy, priors, svf, warm
from deepwmh_tpu_torch.registration.similarity import lncc, winsorize_rescale

SHAPE = (32, 32, 32)
SP1 = (1.0, 1.0, 1.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny products run single-threaded: with the test workers sharing the
    cores, torch's thread pool turns a 3x512 product into milliseconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("cohort"))
    return chip_smoke.registration_cohort(folder, SHAPE, SP1, n_targets=2, seed=0, amp=1.5)


def _short_cfgs(mod):
    return (mod[0].AffineConfig(shrinks=(4,), iters=(1,)),
            mod[1].SVFConfig(shrinks=(4,), iters=(2,), n_squaring=4, exact_polish_iters=1))


def _one_pair_bars(got, want, fixed):
    mat, _, disp16, _, warped16 = got
    jmat, _, jdisp16, _, jwarped16 = want
    np.testing.assert_allclose(mat, np.asarray(jmat), atol=2e-3)
    assert np.abs(disp16.astype(np.float32) - np.asarray(jdisp16, np.float32)).max() <= 0.05
    span = float(fixed.max() - fixed.min())
    assert np.abs(warped16.astype(np.float32) - np.asarray(jwarped16, np.float32)).max() \
        <= 1e-2 * span


def test_pair_core_matches_jax(cohort):
    """One pair through both ``_pair_core``s (f16 uploads and outputs), a
    short schedule: the one-pair bars, and the source label carried by each
    package's own transform at least 99.5% equal."""
    _, _, cases = cohort
    fixed = nifti.load_nifti_simple(cases["tgt0"][0]).astype(np.float16)
    moving = nifti.load_nifti_simple(cases["src1"][0]).astype(np.float16)
    label = nifti.load_nifti_simple(cases["src1"][1])
    acfg, scfg = _short_cfgs((affine, svf))
    jacfg, jscfg = _short_cfgs((jaffine, jsvf))
    sp = np.ones(3, np.float32)
    want = jgroup._pair_core_jit(jnp.asarray(fixed), jnp.asarray(moving), jnp.asarray(sp),
                                 jnp.asarray(sp), jacfg, jscfg, deformable=True)
    got = group._to_host(group._pair_core(torch.from_numpy(fixed), torch.from_numpy(moving),
                                          T(sp), T(sp), acfg, scfg, True))
    assert got[2].dtype == np.float16 and got[4].dtype == np.float16
    _one_pair_bars(got, want, fixed.astype(np.float32))
    lab = svf.apply_affine_svf(T(label), got[0], T(got[2]), SHAPE, SP1, SP1, order=0).numpy()
    jlab = np.asarray(jsvf.apply_affine_svf(label, np.asarray(want[0]), np.asarray(want[2]),
                                            SHAPE, SP1, SP1, order=0))
    assert (lab == jlab).mean() >= 0.995


def _dice(a, b):
    return 2.0 * float((a & b).sum()) / max(float(a.sum() + b.sum()), 1.0)


def _quality(out, cases, pair, package):
    """(LNCC of target and warped source, Dice of the propagated source
    brain against the target's) of one pair directory."""
    s, t = pair.split("_to_")
    target = nifti.load_nifti_simple(cases[t][0])
    warped = nifti.load_nifti_simple(os.path.join(out, pair + ".nii.gz"))
    lab_out = os.path.join(out, "prop_%s_%s.nii.gz" % (package, pair))
    apply = (group.apply_pair_transforms if package == "port"
             else jgroup.apply_pair_transforms)
    kw = {"device": "cpu"} if package == "port" else {}
    apply(os.path.join(out, pair), [cases[s][1]], [lab_out], **kw)
    lab = nifti.load_nifti_simple(lab_out)
    want = nifti.load_nifti_simple(cases[t][1])
    score = float(lncc(winsorize_rescale(T(target)), winsorize_rescale(T(warped)), radius=2))
    return score, _dice(lab > 0.5, want > 0.5), lab


PRESET = ["--keep-deformation", "--allow-quick-registration", "--allow-large-deformations"]


def test_group_cli_both_packages(cohort, tmp_path, capsys):
    """Both CLIs with the training-prep preset on the 2x2 cohort: the same
    artifacts (files, JSON fields, dtypes, shapes), each package probing and
    propagating through the other's pairs, and pairs as good as JAX's:
    LNCC after registration above LNCC before and within 0.03 of JAX's,
    propagated brain Dice within 0.02 of JAX's. A re-run skips every pair."""
    src, tgt, cases = cohort
    outs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    cli.main(["-s", src, "-t", tgt, "-o", outs["port"], "--device", "cpu"] + PRESET)
    jcli.main(["-s", src, "-t", tgt, "-o", outs["jax"]] + PRESET)

    listing = {k: sorted(os.path.relpath(os.path.join(d, f), v)
                         for d, _, fs in os.walk(v) for f in fs)
               for k, v in outs.items()}
    assert listing["port"] == listing["jax"] and len(listing["port"]) == 12
    pairs = sorted(p[:-len(".nii.gz")] for p in listing["port"] if "/" not in p)
    assert pairs == ["src0_to_tgt0", "src0_to_tgt1", "src1_to_tgt0", "src1_to_tgt1"]
    port_reg = group.GroupRegistration([], [], outs["jax"], device="cpu")
    jax_reg = jgroup.GroupRegistration([], [], outs["port"])
    for pair in pairs:
        metas = {}
        for k, v in outs.items():
            with open(os.path.join(v, pair, "affine.json")) as f:
                metas[k] = json.load(f)
        assert set(metas["port"]) == set(metas["jax"])
        for key in ("fixed_spacing", "moving_spacing", "fixed_shape", "deformable", "warp_kept"):
            assert metas["port"][key] == metas["jax"][key], key
        for name in (pair + ".nii.gz", pair + "/warp.nii.gz"):
            a, ha = nifti.load_nifti(os.path.join(outs["port"], name))
            b, hb = jnifti.load_nifti(os.path.join(outs["jax"], name))
            assert a.shape == b.shape and ha.datatype == hb.datatype and np.isfinite(a).all()
        # each package's probes accept the other's pair directories
        s, t = pair.split("_to_")
        assert port_reg._pair_done(port_reg._pair_paths(s, t))
        assert jax_reg._pair_done(jax_reg._pair_paths(s, t))
        # each package's label propagation through the same pair agrees
        q = {}
        for k, v in outs.items():
            q[k] = {pkg: _quality(v, cases, pair, pkg) for pkg in ("port", "jax")}
            assert (q[k]["port"][2] == q[k]["jax"][2]).mean() >= 0.995
        before = float(lncc(winsorize_rescale(T(nifti.load_nifti_simple(cases[t][0]))),
                            winsorize_rescale(T(nifti.load_nifti_simple(cases[s][0]))), 2))
        (p_lncc, p_dice, _), (j_lncc, j_dice, _) = q["port"]["port"], q["jax"]["jax"]
        assert p_lncc > before and p_lncc >= j_lncc - 0.03, (pair, before, p_lncc, j_lncc)
        assert p_dice >= j_dice - 0.02, (pair, p_dice, j_dice)

    stamp = {f: os.path.getmtime(os.path.join(outs["port"], f)) for f in listing["port"]}
    capsys.readouterr()
    cli.main(["-s", src, "-t", tgt, "-o", outs["port"], "--device", "cpu"] + PRESET)
    assert "4 pair(s) already done" in capsys.readouterr().out
    assert stamp == {f: os.path.getmtime(os.path.join(outs["port"], f)) for f in stamp}


def test_group_cli_refuses_without_card_or_with_mesh(cohort, tmp_path):
    src, tgt, _ = cohort
    argv = ["-s", src, "-t", tgt, "-o", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            priors_cli.main(["-a", src, "-l", src, "-i", src, "-o", str(tmp_path / "p")])
    with pytest.raises(SystemExit, match="A13"):
        cli.main(argv + ["--mesh", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(argv + ["-g", "0", "--device", "cpu"])
    reg = group.GroupRegistration([("a", src)], [("b", tgt)], str(tmp_path / "g"), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        reg.launch(mesh=object())


def test_warm_start_matches_jax(cohort, tmp_path):
    """The composed displacement (within 1e-4) and one warm pair on a short
    schedule (the one-pair bars) from the same anchor and auxiliary pairs;
    then the warm launch through the port: the auxiliary pair under
    _warm_aux, every pair complete, a re-run registering nothing."""
    src, tgt, cases = cohort
    d0t = chip_smoke.smooth_velocity(SHAPE, 1.5, 7).astype(np.float16)
    di0 = chip_smoke.smooth_velocity(SHAPE, 1.0, 8).astype(np.float16)
    mats = [chip_smoke.small_affine(SHAPE, SP1, s) for s in (1, 2, 3)]
    sp = np.ones(3, np.float32)
    sp_t = np.array([1.0, 1.0, 1.2], np.float32)
    want = jwarm.compose_pair_displacement(jnp.asarray(d0t, jnp.float32),
                                           jnp.asarray(di0, jnp.float32), *mats, sp_t, sp, SHAPE)
    got = warm.compose_pair_displacement(T(d0t), T(di0), *[T(m) for m in mats], T(sp_t), T(sp),
                                         SHAPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    fixed = nifti.load_nifti_simple(cases["tgt1"][0]).astype(np.float16)
    moving = nifti.load_nifti_simple(cases["src1"][0]).astype(np.float16)
    acfg, scfg = _short_cfgs((affine, svf))
    jacfg, jscfg = _short_cfgs((jaffine, jsvf))
    args = (d0t, di0, mats[0], mats[1], sp)
    jout = jwarm.warm_pair_core_jit(jnp.asarray(fixed), jnp.asarray(moving), jnp.asarray(sp),
                                    jnp.asarray(sp), *[jnp.asarray(a) for a in args],
                                    jacfg, jwarm.warm_schedule(jscfg, floor=1))
    tout = group._to_host(warm.warm_pair_core(
        torch.from_numpy(fixed), torch.from_numpy(moving), T(sp), T(sp),
        torch.from_numpy(d0t), torch.from_numpy(di0), T(mats[0]), T(mats[1]), T(sp), acfg,
        warm.warm_schedule(scfg, floor=1)))
    _one_pair_bars(tout, jout, fixed.astype(np.float32))
    assert warm.warm_schedule(scfg) == svf.SVFConfig(**{
        k: getattr(jwarm.warm_schedule(jscfg), k) for k in svf.SVFConfig.__dataclass_fields__})

    out = str(tmp_path / "warm")
    srcs = [(c, cases[c][0]) for c in ("src0", "src1")]
    tgts = [(c, cases[c][0]) for c in ("tgt0", "tgt1")]
    reg = group.GroupRegistration(srcs, tgts, out, quick=True, warm_start=True, device="cpu")
    reg.launch(verbose=False)
    assert all(reg.pair_complete(s, t) for s, _ in srcs for t, _ in tgts)
    assert os.path.isfile(os.path.join(out, "_warm_aux", "src1_to_src0", "affine.json"))
    jreg = jgroup.GroupRegistration(srcs, tgts, out, quick=True)
    assert all(jreg.pair_complete(s, t) for s, _ in srcs for t, _ in tgts)
    stamp = os.path.getmtime(os.path.join(out, "src1_to_tgt1", "affine.json"))
    group.GroupRegistration(srcs, tgts, out, quick=True, warm_start=True,
                            device="cpu").launch(verbose=False)
    assert os.path.getmtime(os.path.join(out, "src1_to_tgt1", "affine.json")) == stamp


def test_policy_resolves_like_jax(monkeypatch):
    """Given JAX's constants, every case resolves as JAX's; the port's own
    constants are the H100's."""
    for name in ("T_SVF_PAIR_S", "T_LEARNED_PAIR_S", "LEARNED_FIXED_COMPILE_S",
                 "LEARNED_FIXED_SCALED_S", "BENCH_VOXELS", "QUALITY_INSURANCE_FACTOR"):
        monkeypatch.setattr(policy, name, getattr(jpolicy, name))
    for S, T_ in ((1, 1), (3, 5), (10, 15), (10, 50), (10, 100), (30, 100), (100, 100)):
        for vox in (None, 64 * 80 * 64, 96 * 112 * 96, 192 * 224 * 192, 256 * 256 * 180):
            for dist in (None, "1/2"):
                for mode in ("auto", "svf", "learned"):
                    assert policy.select_registration_mode(S, T_, mode, dist, vox) == \
                        jpolicy.select_registration_mode(S, T_, mode, dist, vox)
            assert policy.estimated_totals_s(S * T_, vox) == jpolicy.estimated_totals_s(S * T_, vox)
    with pytest.raises(ValueError):
        policy.select_registration_mode(1, 1, "fast")


@pytest.mark.parametrize("S,T_,voxels,card,jax_mode", [
    (5, 3, 64 * 80 * 64, "svf", "svf"),
    (12, 14, 64 * 80 * 64, "svf", "svf"),
    (3, 3, 64 * 80 * 64, "svf", "svf"),
    (10, 50, 192 * 224 * 192, "learned", "learned"),
    (13, 13, 64 * 80 * 64, "learned", "svf"),
])
def test_policy_card_constants_pin_modes(S, T_, voxels, card, jax_mode):
    """The modes the card's constants give (policy.py, read by
    ``chip_smoke.py --e2e-dice`` at 64x80x64: 11.82 s an svf pair, 0.196 s
    a learned pair, 68.7 s of learned fixed cost) beside JAX's. Up to 168
    pairs auto keeps svf, the mode that every full train -> predict loop
    measured there favoured (JAX's at 15 and 168 pairs, the card's at
    5 x 3), so the card gives JAX's mode at 5 x 3, 12 x 14 (168 pairs) and
    3 x 3 (chip_smoke's train_e2e cohort); bench shape 10 x 50 agrees
    too. 13 x 13 = 169 pairs is beyond that rule, and there the card's
    cost model picks learned where JAX's keeps svf up to 2,389 pairs: on
    the card a learned pair costs ~60x less than an svf pair, so learned
    amortises its fixed cost sooner. That is the card's cost, not a
    fault."""
    assert policy.select_registration_mode(S, T_, volume_voxels=voxels) == card
    assert jpolicy.select_registration_mode(S, T_, volume_voxels=voxels) == jax_mode


def test_priors_match_jax(tmp_path):
    """synthetic_atlas and convert_freesurfer_aseg bit-equal; both priors
    CLIs (--quick, the synthetic atlas written by --make-atlas) on one
    subject whose true labels are known: the same files, and labels as good
    as JAX's (agreement with the truth and brain Dice within 0.02 of JAX's).
    Not voxel for voxel: the quick preset's MI levels are small (12x14x12
    and 24x28x24 here); on a 10x12x10 level the two packages' rigid
    parameters, 3e-6 apart after five steps, were 0.04 apart after twenty
    and 0.4 after fifty (measured)."""
    for kw in ({}, {"shape": (20, 24, 18), "spacing": (1.0, 1.0, 1.0), "seed": 3}):
        for a, b in zip(priors.synthetic_atlas(**kw), jpriors.synthetic_atlas(**kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    aseg = np.random.RandomState(0).randint(0, 60, (9, 8, 7)).astype(np.float32) + 0.2
    assert np.array_equal(priors.convert_freesurfer_aseg(aseg),
                          jpriors.convert_freesurfer_aseg(aseg))

    image, label = priors.synthetic_atlas(seed=4)
    truth = np.roll(label, 3, axis=1)
    hdr = nifti.NiftiHeader()
    hdr.set_shape(image.shape)
    hdr.set_zooms((2.0, 2.0, 2.0))
    subj = str(tmp_path / "subj.nii.gz")
    nifti.save_nifti(np.roll(image, 3, axis=1), hdr, subj)
    csv = str(tmp_path / "in.csv")
    with open(csv, "w") as f:
        f.write("case,flair\ns1,%s\n" % subj)
    outs, score = {}, {}
    for name, main, extra in (("port", priors_cli.main, ["--device", "cpu"]),
                              ("jax", jpriors_cli.main, [])):
        outs[name] = str(tmp_path / name)
        main(["--make-atlas", str(tmp_path / ("atlas_" + name)), "-i", csv, "-o", outs[name],
              "--quick"] + extra)
        l1 = nifti.load_nifti_simple(os.path.join(outs[name], "s1_label1.nii.gz"))
        l2 = nifti.load_nifti_simple(os.path.join(outs[name], "s1_label2.nii.gz"))
        assert set(np.unique(l2)) <= {0.0, 1.0, 2.0, 3.0}
        assert np.array_equal(l1, (l2 > 0.5).astype(np.float32))
        score[name] = ((l2 == truth).mean(), _dice(l1 > 0.5, truth > 0.5))
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    assert score["port"][0] >= score["jax"][0] - 0.02 and score["port"][1] >= \
        score["jax"][1] - 0.02, score
