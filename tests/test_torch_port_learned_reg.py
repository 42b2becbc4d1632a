"""deepwmh_tpu_torch template construction and learned registration against
the JAX package on the CPU, with JAX's network parameters carried across
(``load_flax_params``; flax's initial draws cannot be replayed):

- ``build_affine_template`` with one step a level: template rtol 1e-5 of
  the range, matrices 2e-3;
- ``LearnedRegistration.register``: the f32 model within 1e-4 voxel, the
  bf16 model (K1's plain version on the CPU) within 1.5x the distance of
  JAX's bf16 field from its f32 one;
- two f32 training steps on the same batch: loss rtol 1e-5, parameters
  within 1e-5 of their largest magnitude (with the exceptions its test
  states: Adam's first steps follow the sign of near-zero gradients);
- ``_lift_core`` / ``_disp_to_target_grid`` within 1e-4 voxel;
- ``LearnedGroupRegistration`` through the port on a 2x2 cohort: the group
  artifacts, read and probed by the JAX package, a re-run doing nothing;
  over a 2-shard CPU mesh, the network trained data parallel.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import chip_smoke
from deepwmh_tpu.registration import affine as jaffine
from deepwmh_tpu.registration import group as jgroup
from deepwmh_tpu.registration import learned as jlearned
from deepwmh_tpu.registration import learned_group as jlg
from deepwmh_tpu.registration import template as jtemplate
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.registration import affine, learned, learned_group, template
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.model import UNet3D
from deepwmh_tpu_torch.utils.adam import Adam

GRID = (14, 16, 12)  # padded to 16x16x12 for the 2-pool test network


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


def _cohort_volumes(n=3, shape=GRID, seed=0):
    from deepwmh_tpu_torch.registration.priors import synthetic_atlas

    return [np.roll(synthetic_atlas(shape, (2.0, 2.0, 2.0), seed=seed + i)[0], i - 1, axis=0)
            for i in range(n)]


def test_build_affine_template_matches_jax():
    vols = _cohort_volumes(3, (32, 36, 28))
    spacings = [(1.0, 1.0, 1.0), (1.0, 1.1, 1.0), (0.9, 1.0, 1.0)]
    kw = dict(spacings=spacings, out_spacing=(2.0, 2.0, 2.0), iterations=1, verbose=False)
    jt, jm = jtemplate.build_affine_template(
        vols, cfg=jaffine.AffineConfig(shrinks=(4, 2), iters=(1, 1)), **kw)
    tt, tm = template.build_affine_template(
        vols, cfg=affine.AffineConfig(shrinks=(4, 2), iters=(1, 1)), device="cpu", **kw)
    assert tt.shape == jt.shape == (16, 18, 14)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5 * float(np.ptp(jt)) + 1e-3)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a, b, atol=2e-3)


def _registrations(dtype):
    """(port, JAX) LearnedRegistration on GRID with the same parameters."""
    small = dict(steps=2, lr=1e-3, base_features=4, max_features=8, num_pools=2)
    cfg = learned.LearnedRegConfig(**small)
    jcfg = jlearned.LearnedRegConfig(**small)
    jreg = jlearned.LearnedRegistration(GRID, jcfg)
    jreg.model = JUNet3D(plan=jreg.plan, dtype=jnp.float32 if dtype == torch.float32
                         else jnp.bfloat16)
    x0 = jnp.zeros((1,) + jreg.pad_shape + (2,), jnp.float32)
    jreg.params = jreg.model.init(jax.random.PRNGKey(0), x0)["params"]
    reg = learned.LearnedRegistration(GRID, cfg, device="cpu")
    reg.model = UNet3D(reg.plan, dtype=dtype, fused_norm=False).to(
        memory_format=torch.channels_last_3d)
    reg.load_flax_params(jax.tree_util.tree_map(np.asarray, jreg.params))
    return reg, jreg


@pytest.fixture(scope="module")
def jax_fields():
    """JAX's registered field of one pair with the f32 and the bf16 model
    (the same parameters)."""
    vols = _cohort_volumes(2)
    return vols, {dt: _registrations(dt)[1].register(vols[0], vols[1])
                  for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_register_matches_jax(dtype, jax_fields):
    """f32: within 1e-4 voxel. bf16: within 1.5x the distance of JAX's
    bf16 field from JAX's f32 field. bf16 activations are rounded at other
    points of a block than flax's, and bf16 rounding moves the field that
    much in either package (measured: port to JAX 0.117 voxel, JAX bf16 to
    JAX f32 0.104)."""
    vols, fields = jax_fields
    reg, _ = _registrations(dtype)
    got = reg.register(vols[0], vols[1])  # the model on K1 (its plain version here)
    assert got.shape == (3,) + GRID and np.isfinite(got).all()
    assert not any(b.fused_norm for b in reg.model.blocks)  # back to training mode
    want = fields[dtype]
    bar = 1e-4 if dtype == torch.float32 else 1.5 * float(
        np.abs(fields[torch.bfloat16] - fields[torch.float32]).max())
    assert np.abs(got - want).max() <= bar, (np.abs(got - want).max(), bar)
    assert np.abs(want).max() > 10 * 1e-4  # a field, not zeros


def test_two_training_steps_match_jax():
    """Two Adam steps of the f32 model on one batch: loss rtol 1e-5,
    parameters within 1e-5 of their largest magnitude but for 0.1% of the
    elements. Adam's first steps are g / (|g| + eps) per element, so where
    a gradient is near 0 its 1e-4 relative gap (measured, per leaf) is a
    different step: 0.017% of the elements, by up to 2.6e-4 (measured). The
    conv biases in front of an instance norm are held to 2 x lr a step: the
    norm removes them, so their exact gradient is 0 and both packages'
    are rounding noise (1e-9..1e-6, measured) that Adam turns into +-lr."""
    vols = _cohort_volumes(2)
    reg, jreg = _registrations(torch.float32)
    wf = [np.asarray(jlearned.winsorize_rescale(jnp.asarray(v))) for v in vols]
    jreg.tx = optax.adam(1e-3)
    params, state = jreg.params, jreg.tx.init(jreg.params)
    opt = Adam(list(reg.model.parameters()), 1e-3)
    for _ in range(2):
        params, state, jl = jreg._train_step(params, state, jnp.asarray(wf[0])[None],
                                             jnp.asarray(wf[1])[None])
        tl = reg.train_step(opt, T(wf[0])[None], T(wf[1])[None])
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = ckpt.params_to_flax(dict(reg.model.named_parameters()))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_j) == set(flat_t)
    scale = max(float(np.abs(v).max()) for v in flat_j.values())
    noise = {k for k in flat_j if "ConvNormAct" in jax.tree_util.keystr(k)
             and "Conv_0" in jax.tree_util.keystr(k) and "bias" in jax.tree_util.keystr(k)}
    assert len(noise) == 4 * reg.plan.num_pools + 2
    gaps = {k: np.abs(np.asarray(flat_t[k]) - np.asarray(v)).ravel() for k, v in flat_j.items()}
    rest = np.concatenate([g for k, g in gaps.items() if k not in noise])
    assert (rest <= 1e-5 * scale).mean() >= 0.999, ((rest > 1e-5 * scale).sum(), rest.max())
    assert max(gaps[k].max() for k in noise) <= 2 * 2 * 1e-3


def test_lift_matches_jax():
    rng = np.random.RandomState(3)
    disp_T = chip_smoke.smooth_velocity((12, 14, 10), 2.0, 4)
    M_t = chip_smoke.small_affine((12, 14, 10), (2.0, 2.0, 2.0), 5)
    sp_T, sp_t, t_shape = (2.0, 2.0, 2.0), (1.0, 1.2, 1.0), (22, 24, 20)
    want = jlg._disp_to_target_grid(disp_T, M_t, sp_T, sp_t, t_shape)
    got = learned_group._disp_to_target_grid(disp_T, M_t, sp_T, sp_t, t_shape, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)
    a, b = rng.randn(3, 4), rng.randn(3, 4)
    np.testing.assert_array_equal(learned_group._compose_affines(a, b), jlg._compose_affines(a, b))


def test_learned_group_registration_artifacts(tmp_path):
    """The port's LearnedGroupRegistration (a few training steps) on a 2x2
    cohort: GroupRegistration's artifacts, which the JAX package probes and
    propagates labels through; a re-run registers nothing."""
    folder = str(tmp_path / "cohort")
    _, _, cases = chip_smoke.registration_cohort(folder, (32, 32, 32), (1.0, 1.0, 1.0),
                                                 n_targets=2, seed=0, amp=1.5)
    srcs = [(c, cases[c][0]) for c in ("src0", "src1")]
    tgts = [(c, cases[c][0]) for c in ("tgt0", "tgt1")]
    out = str(tmp_path / "out")
    kw = dict(reg_cfg=learned.LearnedRegConfig(steps=3),
              template_cfg=affine.AffineConfig(shrinks=(2,), iters=(5,)),
              template_iterations=1, device="cpu")
    lg = learned_group.LearnedGroupRegistration(srcs, tgts, out, **kw)
    lg.launch(verbose=False)
    jlg_probe = jlg.LearnedGroupRegistration(srcs, tgts, out)
    for (s, _), (t, _) in ((a, b) for a in srcs for b in tgts):
        assert lg.pair_complete(s, t) and jlg_probe.pair_complete(s, t)
        pair = "%s_to_%s" % (s, t)
        with open(os.path.join(out, pair, "affine.json")) as f:
            meta = json.load(f)
        assert meta["method"] == "learned" and meta["fixed_shape"] == [32, 32, 32]
        warp = nifti.load_nifti_simple(os.path.join(out, pair, "warp.nii.gz"))
        assert warp.shape == (32, 32, 32, 3) and np.isfinite(warp).all()
        lab = str(tmp_path / ("lab_" + pair + ".nii.gz"))
        jgroup.apply_pair_transforms(os.path.join(out, pair), [cases[s][1]], [lab])
        assert set(np.unique(nifti.load_nifti_simple(lab))) <= {0.0, 1.0, 2.0, 3.0}
    stamp = os.path.getmtime(os.path.join(out, "src1_to_tgt1", "affine.json"))
    learned_group.LearnedGroupRegistration(srcs, tgts, out, **kw).launch(verbose=False)
    assert os.path.getmtime(os.path.join(out, "src1_to_tgt1", "affine.json")) == stamp
    # over a 2-shard CPU mesh: the network trains data parallel (the mesh
    # reaches train()), the pairs are complete
    from deepwmh_tpu_torch.parallel.mesh import Mesh

    meshes, train = [], learned.LearnedRegistration.train
    mesh = Mesh(["cpu"] * 2)
    out_mesh = str(tmp_path / "out_mesh")
    try:
        learned.LearnedRegistration.train = (
            lambda self, *a, **k: meshes.append(k.get("mesh")) or train(self, *a, **k))
        lg_mesh = learned_group.LearnedGroupRegistration(srcs, tgts, out_mesh, mesh=mesh, **kw)
        lg_mesh.launch(verbose=False)
    finally:
        learned.LearnedRegistration.train = train
    assert meshes == [mesh]
    assert all(lg_mesh.pair_complete(s, t) for s, _ in srcs for t, _ in tgts)
