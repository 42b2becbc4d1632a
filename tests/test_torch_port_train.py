"""deepwmh_tpu_torch U-Net training against the JAX package on the CPU.

Each module of the trainer against the JAX function it replaces, on the
same inputs: losses and hard Dice (atol 1e-6), the patch sampler (byte for
byte), the affine warp and rotation matrix (order 0 exactly, halves
included; order 1 within 1e-5), each augmentation branch applied to JAX's
own draws, the clip / decay / Nesterov update against optax (1e-6 of the
largest parameter), one and two f32 train steps against the JAX trainer's
step (loss rtol 1e-5; gradients, parameters and momentum 1e-5 of their
largest magnitude), checkpoints read by either package, a bf16 Trainer run
resumed from a JAX-written model_latest beside the JAX Trainer's run, and
flax's initialiser distribution. The tolerance of each test is in it.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deepwmh_tpu.ops import warp as jwarp
from deepwmh_tpu.unet import augment as jaug
from deepwmh_tpu.unet import checkpoint as jckpt
from deepwmh_tpu.unet import losses as jlosses
from deepwmh_tpu.unet.data import SegDataset as JSegDataset
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.plan import Plan as JPlan
from deepwmh_tpu.unet.train import TrainConfig as JTrainConfig
from deepwmh_tpu.unet.train import Trainer as JTrainer
from deepwmh_tpu_torch.ops import warp
from deepwmh_tpu_torch.unet import augment, losses
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet import model as tmodel
from deepwmh_tpu_torch.unet.data import SegDataset
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer, opt_state_tree


def tiny_plan(cls=Plan):
    return cls(target_spacing=[2.0] * 3, patch_size=[16, 16, 16], batch_size=2,
               pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
               base_features=4, max_features=8)


def micro_plan(cls=Plan):
    return cls(target_spacing=[1.0] * 3, patch_size=[8, 8, 8], batch_size=2,
               pool_kernels=[[2, 2, 2]], conv_kernels=[[3, 3, 3], [3, 3, 3]],
               base_features=2, max_features=4)


def _jax_to_torch_logits(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("classes", [2, 3])
def test_losses_match_jax(classes):
    """atol 1e-6 (f32 sums over a few thousand voxels in another order)."""
    rng = np.random.RandomState(classes)
    logits = rng.randn(2, 8, 6, 10, classes).astype(np.float32)
    target = rng.randint(0, classes, (2, 8, 6, 10)).astype(np.int32)
    logits[0, 0, 0, 0, -1] = -np.inf  # a suppressed non-target class
    target[0, 0, 0, 0] = 0
    jl, jt = jnp.asarray(logits), jnp.asarray(target)
    tl, tt = _jax_to_torch_logits(logits), torch.from_numpy(target)
    for jf, tf in ((jlosses.softmax_ce, losses.softmax_ce),
                   (jlosses.ce_dice_loss, losses.ce_dice_loss)):
        got, want = float(tf(tl, tt)), float(jf(jl, jt))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, atol=1e-6)
    for batch_dice in (True, False):
        np.testing.assert_allclose(float(losses.soft_dice(tl, tt, batch_dice)),
                                   float(jlosses.soft_dice(jl, jt, batch_dice)), atol=1e-6)
    pred = rng.rand(2, 8, 6, 10).astype(np.float32)
    np.testing.assert_allclose(float(losses.hard_dice(torch.from_numpy(pred), tt > 0)),
                               float(jlosses.hard_dice(jnp.asarray(pred), jt > 0)), atol=1e-6)
    for n in (1, 2, 4):
        assert losses.ds_weights(n) == jlosses.ds_weights(n)


def test_deep_supervision_loss_matches_jax():
    """Three levels at strides 1, (2,2,1), (4,4,2): atol 1e-6."""
    rng = np.random.RandomState(0)
    pools = [[2, 2, 1], [2, 2, 2]]
    target = (rng.rand(2, 16, 12, 8) > 0.6).astype(np.int32)
    shapes = [(16, 12, 8), (8, 6, 8), (4, 3, 4)]
    outs = [(rng.randn(2, *s, 2) * 2).astype(np.float32) for s in shapes]
    want = float(jlosses.deep_supervision_loss([jnp.asarray(o) for o in outs],
                                               jnp.asarray(target), pools))
    got = float(losses.deep_supervision_loss([_jax_to_torch_logits(o) for o in outs],
                                             torch.from_numpy(target), pools))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(
        losses.downsample_target(torch.from_numpy(target), (2, 2, 2)).numpy(),
        np.asarray(jlosses.downsample_target(jnp.asarray(target), (2, 2, 2))))


# -------------------------------------------------------------------- data


def _datasets(patch, cls_pair=(JSegDataset, SegDataset)):
    rng = np.random.RandomState(3)
    out = [cls(patch) for cls in cls_pair]
    for i, size in enumerate([(20, 18, 16), (10, 22, 12), (24, 24, 24)]):
        img = rng.randn(*size).astype(np.float32)
        lbl = (rng.rand(*size) > (0.995 if i else 0.2)).astype(np.uint8)  # case 0: > 10000 fg
        for ds in out:
            ds.add_case("c%d" % i, img, lbl)
    return out


def test_seg_dataset_batches_equal_jax_byte_for_byte():
    """The same RandomState gives the same batches (images and labels
    byte for byte, dtypes included) and leaves the generator in the same
    state, with cases padded to the patch and > 10000 fg voxels."""
    jds, tds = _datasets((12, 16, 14))
    assert jds.names == tds.names and len(jds) == len(tds) == 3
    for batch, fg in ((2, 0.33), (3, 1.0), (4, 0.0)):
        jr, tr = np.random.RandomState(batch), np.random.RandomState(batch)
        for _ in range(5):
            (ji, jl), (ti, tl) = jds.sample_batch(jr, batch, fg), tds.sample_batch(tr, batch, fg)
            assert ji.dtype == ti.dtype and jl.dtype == tl.dtype
            assert ji.tobytes() == ti.tobytes() and jl.tobytes() == tl.tobytes()
        assert jr.randint(1 << 30) == tr.randint(1 << 30)
    with pytest.raises(ValueError, match="differ in shape"):
        tds.add_case("bad", np.zeros((4, 4, 4), np.float32), np.zeros((4, 4, 5), np.uint8))


# -------------------------------------------------------------------- warp


def test_round_half_away_from_zero():
    c = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, 2.4999998, -0.4999, 3.0,
                      -7.0, 1e7 + 1.0])
    want = np.asarray(jax.lax.round(jnp.asarray(c.numpy())))
    np.testing.assert_array_equal(warp.round_half_away(c).numpy(), want)


def test_sample_volume_matches_map_coordinates():
    """Order 0 exactly and order 1 within 1e-6 at coordinates in range, out
    of range, on the edge and exactly at .5 (where torch's round would go
    to the even neighbour)."""
    rng = np.random.RandomState(0)
    vol = rng.randn(6, 7, 5).astype(np.float32)
    coords = rng.uniform(-1.5, 8.0, (3, 4, 9, 5)).astype(np.float32)
    coords[:, 0, 0, :] = np.array([0.5, 1.5, 2.5, -0.5, 4.5])[None, :]  # halves
    coords[:, 0, 1, :] = np.array([5.0, 6.0, 4.0, 0.0, -1.0])[None, :]  # edges and outside
    for order in (0, 1):
        want = np.asarray(jwarp.sample_volume(jnp.asarray(vol), jnp.asarray(coords), order=order))
        got = warp.sample_volume(torch.from_numpy(vol), torch.from_numpy(coords), order=order).numpy()
        if order == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(warp.identity_grid((3, 4, 2)).numpy(),
                                  np.asarray(jwarp.identity_grid((3, 4, 2))))


def test_affine_warp_and_rotation_match_jax():
    """rotation_matrix within 1e-6; affine_warp of an integer label volume
    through a rotation + scaling about the centre: order 0 equal on >= 99.9%
    of voxels (a coordinate within an ulp of .5 may round either way after
    another summation order) and order 1 within 1e-5; an exact half-voxel
    shift (every coordinate at .5) equal voxel for voxel."""
    angles = np.array([0.3, -0.41, 0.2], np.float32)
    R = warp.rotation_matrix(torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(R, np.asarray(jwarp.rotation_matrix(jnp.asarray(angles))),
                               atol=1e-6)
    rng = np.random.RandomState(1)
    img = rng.randn(16, 14, 12).astype(np.float32)
    lbl = rng.randint(0, 3, (16, 14, 12)).astype(np.float32)
    A = R.T / np.float32(1.2)
    mat = np.concatenate([A, np.zeros((3, 1), np.float32)], axis=1)
    center = [(s - 1) / 2.0 for s in img.shape]
    got1 = warp.affine_warp(torch.from_numpy(img), mat, order=1, center=center).numpy()
    want1 = np.asarray(jwarp.affine_warp(jnp.asarray(img), jnp.asarray(mat), order=1,
                                         center=center))
    np.testing.assert_allclose(got1, want1, atol=1e-5)
    got0 = warp.affine_warp(torch.from_numpy(lbl), mat, order=0, center=center).numpy()
    want0 = np.asarray(jwarp.affine_warp(jnp.asarray(lbl), jnp.asarray(mat), order=0,
                                         center=center))
    assert (got0 == want0).mean() >= 0.999
    shift = np.concatenate([np.eye(3, dtype=np.float32), np.full((3, 1), 0.5, np.float32)], 1)
    for order in (0, 1):
        np.testing.assert_array_equal(
            warp.affine_warp(torch.from_numpy(lbl), shift, order=order).numpy(),
            np.asarray(jwarp.affine_warp(jnp.asarray(lbl), jnp.asarray(shift), order=order)))


# ----------------------------------------------------------- augmentation


def _jax_draws(key, shape, cfg):
    """The values augment_sample draws from ``key``, as the port's
    AugmentDraws."""
    keys = jax.random.split(key, 13)
    u = lambda k, lo=0.0, hi=1.0, s=(): jax.random.uniform(k, s, minval=lo, maxval=hi)  # noqa
    return augment.AugmentDraws(
        angles=tuple(float(a) for a in u(keys[0], -cfg.rot_max_rad, cfg.rot_max_rad, (3,))),
        scale=float(u(keys[1], *cfg.scale_range)),
        spatial=bool(u(keys[2]) < cfg.p_rotscale),
        noise_std=float(u(keys[3], 0.0, cfg.noise_std_max)),
        noise=torch.from_numpy(np.array(jax.random.normal(keys[4], shape))),
        noise_on=bool(u(keys[5]) < cfg.p_noise),
        brightness=float(u(keys[6], *cfg.brightness_range)),
        brightness_on=bool(u(keys[7]) < cfg.p_brightness),
        contrast=float(u(keys[8], *cfg.contrast_range)),
        contrast_on=bool(u(keys[9]) < cfg.p_contrast),
        gamma=float(u(keys[10], *cfg.gamma_range)),
        gamma_on=bool(u(keys[11]) < cfg.p_gamma),
        mirror=tuple(bool(u(k) < cfg.p_mirror) for k in jax.random.split(keys[12], 3)),
    )


_OFF = dict(p_rotscale=0.0, p_noise=0.0, p_brightness=0.0, p_contrast=0.0, p_gamma=0.0,
            p_mirror=0.0)


@pytest.mark.parametrize("branch", ["p_rotscale", "p_noise", "p_brightness", "p_contrast",
                                    "p_gamma", "p_mirror", "all"])
def test_augment_apply_matches_jax_given_its_draws(branch):
    """Each branch alone (its probability 1, the others 0), and all at once:
    the image within 1e-5 of its range (gamma's pow and contrast's mean in
    another order), the label equal on >= 99.9% of voxels (an order-0
    coordinate an ulp from .5 may round either way)."""
    probs = {k: 1.0 for k in _OFF} if branch == "all" else {**_OFF, branch: 1.0}
    jcfg, tcfg = jaug.AugmentConfig(**probs), augment.AugmentConfig(**probs)
    rng = np.random.RandomState(7)
    shape = (16, 12, 14)
    img = rng.randn(*shape).astype(np.float32)
    lbl = (rng.rand(*shape) > 0.8).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want_i, want_l = (np.asarray(a) for a in jaug.augment_sample(
        key, jnp.asarray(img), jnp.asarray(lbl), jcfg))
    d = _jax_draws(key, shape, jcfg)
    got_i, got_l = augment.apply_augment(torch.from_numpy(img), torch.from_numpy(lbl), d)
    assert got_l.dtype == torch.int64
    span = float(want_i.max() - want_i.min())
    np.testing.assert_allclose(got_i.numpy(), want_i, atol=1e-5 * span)
    assert (got_l.numpy() == want_l).mean() >= 0.999
    if branch not in ("p_rotscale", "all"):
        np.testing.assert_array_equal(got_l.numpy(), want_l)


def test_augment_draws_follow_the_config():
    """The port's own draws: the 13 values in their ranges, the coins at
    their probabilities (2000 samples, 4 sigma), and one generator seed
    gives one stream."""
    cfg = augment.AugmentConfig()
    gen = torch.Generator().manual_seed(0)
    ds = [augment.draw_augment(gen, (2, 2, 2), cfg) for _ in range(2000)]
    for flag, p in (("spatial", cfg.p_rotscale), ("noise_on", cfg.p_noise),
                    ("brightness_on", cfg.p_brightness), ("gamma_on", cfg.p_gamma)):
        rate = np.mean([getattr(d, flag) for d in ds])
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / len(ds)), (flag, rate)
    assert all(abs(a) <= cfg.rot_max_rad for d in ds for a in d.angles)
    assert all(cfg.scale_range[0] <= d.scale <= cfg.scale_range[1] for d in ds)
    assert all(0 <= d.noise_std <= cfg.noise_std_max for d in ds)
    again = augment.draw_augment(torch.Generator().manual_seed(0), (2, 2, 2), cfg)
    assert again.angles == ds[0].angles and torch.equal(again.noise, ds[0].noise)


def test_percentile_noise_matches_numpy_percentiles():
    image = torch.from_numpy(np.random.RandomState(0).rand(20, 10, 8).astype(np.float32))
    out = augment.percentile_noise(torch.Generator().manual_seed(3), image, 0.1)
    noise = torch.randn(image.shape, generator=torch.Generator().manual_seed(3))
    q5, q95 = np.percentile(image.numpy(), [5, 95])
    np.testing.assert_allclose(out.numpy(), (image + noise * (0.1 * (q95 - q5))).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(float(jnp.percentile(jnp.asarray(image.numpy()), 95)), q95,
                               rtol=1e-6)


# -------------------------------------------------------------- optimizer


def _jax_tx(cfg):
    return optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                       optax.add_decayed_weights(cfg.weight_decay),
                       optax.sgd(1.0, momentum=cfg.momentum, nesterov=True))


def _jax_params(jplan, dtype=jnp.float32, seed=0):
    x = jnp.zeros((1,) + tuple(jplan.patch_size) + (1,), jnp.bfloat16)
    model = JUNet3D(plan=jplan, dtype=dtype, remat=True, decompose_fullres=False)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"])


def _assert_tree_close(port_sd, jax_tree, rel):
    """Every leaf within ``rel`` times the largest magnitude in the tree
    (a per-leaf scale would hold leaves that are rounding noise, such as
    the gradient of a conv bias that instance norm cancels, to their own
    noise)."""
    want = ckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, jax_tree))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = port_sd[name].detach().cpu()
        assert float((g - w).abs().max()) <= rel * scale, name


@pytest.mark.parametrize("grad_scale", [0.01, 100.0])
def test_update_matches_optax(grad_scale, tmp_path):
    """Two updates from a nonzero momentum, with ||g|| under 12 (0.01) and
    over it (100): parameters and trace within 1e-6 of the largest
    magnitude in their tree."""
    cfg = TrainConfig(epochs=1, batches_per_epoch=4)
    tr = Trainer(tiny_plan(), cfg, str(tmp_path), device="cpu", dtype=torch.float32)
    params = _jax_params(tiny_plan(JPlan))
    tx = _jax_tx(JTrainConfig())
    update = jax.jit(tx.update)
    rng = np.random.RandomState(0)
    state = tx.init(params)
    state = (state[0], state[1], (state[2][0]._replace(trace=jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32) * 0.1, params)), state[2][1]))
    tr.load_state_trees(params, jax.tree_util.tree_map(
        np.asarray, __import__("flax").serialization.to_state_dict(state)))
    for step in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * grad_scale).astype(np.float32), params)
        lr = tr.lr_at(step)
        upd, state = update(grads, state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: u * np.float32(lr),
                                                                    upd))
        tg = ckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        tr.update([tg[n] for n in tr.names], lr)
        _assert_tree_close(dict(zip(tr.names, tr.params)), params, 1e-6)
        _assert_tree_close(dict(zip(tr.names, tr.trace)), state[2][0].trace, 1e-6)


# -------------------------------------------------------------- one step


def _batch(shape, n=2, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, *shape).astype(np.float32)
    labels = (images + 0.5 * rng.randn(n, *shape) > 1.0).astype(np.int32)
    return images, labels


def test_f32_train_steps_match_jax(tmp_path):
    """Two steps of the JAX trainer's _train_step_impl (augmentation off)
    on UNet3D(dtype=float32, remat) against the port's Trainer in f32 from
    the same weights and batches: loss rtol 1e-5; gradients, updated
    parameters and momentum trace within 1e-5 of the largest magnitude in
    their tree."""
    jplan, plan = tiny_plan(JPlan), tiny_plan()
    jtr = JTrainer(jplan, JTrainConfig(augment=False, epochs=1, batches_per_epoch=2),
                   str(tmp_path / "jax"))
    jtr.model = JUNet3D(plan=jplan, dtype=jnp.float32, remat=True, decompose_fullres=False)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(jplan, seed=1))
    opt_state = jtr.tx.init(params)
    tr = Trainer(plan, TrainConfig(augment=False, epochs=1, batches_per_epoch=2),
                 str(tmp_path / "port"), device="cpu", dtype=torch.float32)
    tr.load_state_trees(jax.tree_util.tree_map(np.asarray, params))
    step = jax.jit(jtr._train_step_impl)

    def jloss(p, images, labels):
        outs = jtr.model.apply({"params": p}, images[..., None], deep_supervision=True)
        return jlosses.deep_supervision_loss(outs, labels, jplan.pool_kernels)

    for i in range(2):
        images, labels = _batch((16, 16, 16), seed=i)
        ji, jl = jnp.asarray(images), jnp.asarray(labels)
        jgrads = jax.grad(jloss)(params, ji, jl)
        lr = tr.lr_at(i)
        params, opt_state, want_loss = step(params, opt_state, ji, jl, jax.random.PRNGKey(0),
                                            np.float32(lr))
        ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
        loss = tr.loss(ti, tl)
        grads = torch.autograd.grad(loss, tr.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tr.params, grads)]
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        _assert_tree_close(dict(zip(tr.names, grads)), jgrads, 1e-5)
        tr.update(grads, lr)
        _assert_tree_close(dict(zip(tr.names, tr.params)), params, 1e-5)
        _assert_tree_close(dict(zip(tr.names, tr.trace)), opt_state[2][0].trace, 1e-5)


def test_remat_changes_nothing_but_memory():
    """Remat on and off: the same loss and gradients bit for bit (f32),
    and the parameter names unchanged."""
    plan = tiny_plan()
    images, labels = (torch.from_numpy(a) for a in _batch((16, 16, 16)))
    results = []
    for remat in (True, False):
        m = tmodel.init_weights(tmodel.UNet3D(plan, dtype=torch.float32, fused_norm=False,
                                              remat=remat), torch.Generator().manual_seed(0))
        loss = losses.deep_supervision_loss(m(images[:, None], deep_supervision=True), labels,
                                            plan.pool_kernels)
        results.append((loss, torch.autograd.grad(loss, list(m.parameters()), allow_unused=True),
                        list(m.state_dict())))
    (l1, g1, n1), (l2, g2, n2) = results
    assert n1 == n2 and torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert (a is None and b is None) or torch.equal(a, b)


def test_fused_norm_model_refuses_autograd_and_matches_plain():
    """A model on K1 (fused_norm, the inference default) raises under
    autograd on the CPU too; without autograd its output equals the
    training model's plain chain (bf16: the chains round alike to within
    one bf16 ulp on a few elements)."""
    plan = tiny_plan()
    fused = tmodel.init_weights(tmodel.UNet3D(plan), torch.Generator().manual_seed(0))
    plain = tmodel.UNet3D(plan, fused_norm=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(1, 1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no backward"):
        fused(x)
    with torch.no_grad():
        a, b = fused(x), plain(x)
    assert (a.argmax(1) == b.argmax(1)).float().mean() > 0.99
    torch.testing.assert_close(a, b, atol=0.1, rtol=0.05)


# -------------------------------------------------------------- init


def test_init_weights_follow_flax_lecun_normal():
    """Kernels of a flagship-width conv (fan-in 27 x 32) and a transpose
    conv (fan-in 8 x 32): the sample std within 2% of flax's sample std on
    the same shape and of sqrt(1 / fan_in); every value inside 2 sigma of
    the untruncated scale sqrt(1 / fan_in) / 0.8796, as flax's are, and
    the bound reached within 2%; then every kernel init_weights draws."""
    gen = torch.Generator().manual_seed(0)
    for shape, fan_in in (((64, 32, 3, 3, 3), 32 * 27), ((32, 64, 2, 2, 2), 32 * 8)):
        w = tmodel.truncated_normal(shape, gen) * (np.sqrt(1.0 / fan_in) / tmodel.TRUNC_STD)
        flax_shape = shape[2:] + (fan_in // int(np.prod(shape[2:])), shape[0])
        j = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), flax_shape))
        bound = 2 * np.sqrt(1.0 / fan_in) / tmodel.TRUNC_STD
        assert float(w.abs().max()) <= bound * (1 + 1e-6)
        assert float(w.abs().max()) > 0.98 * bound and np.abs(j).max() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(float(w.std()), float(j.std()), rtol=0.02)
        np.testing.assert_allclose(float(w.std()), np.sqrt(1.0 / fan_in), rtol=0.02)
    model = tmodel.init_weights(tmodel.UNet3D(tiny_plan()), torch.Generator().manual_seed(5))
    for name, p in model.named_parameters():
        if p.dim() > 1:
            cin = p.shape[0] if name.startswith("ups.") else p.shape[1]
            bound = 2 * np.sqrt(1.0 / (cin * np.prod(p.shape[2:]))) / tmodel.TRUNC_STD
            assert float(p.detach().abs().max()) <= bound * (1 + 1e-6), name


# --------------------------------------------------------- checkpoints


def test_training_checkpoints_load_in_both_packages(tmp_path):
    """A port-written model_latest (params and optimizer state) restores
    into the JAX package's load_checkpoint templates bit for bit, and a
    JAX-written one into the port's Trainer."""
    jplan, plan = tiny_plan(JPlan), tiny_plan()
    tr = Trainer(plan, TrainConfig(), str(tmp_path / "port"), device="cpu")
    tr.init_state(3)
    with torch.no_grad():
        for t in tr.trace:
            t.normal_(generator=torch.Generator().manual_seed(4))
    params, opt_state = tr.state_trees()
    snapshot = jax.tree_util.tree_map(np.copy, params)
    kept = [p.detach().clone() for p in tr.params]
    with torch.no_grad():
        for p in tr.params:
            p.add_(1.0)  # the trees share no memory with the live tensors
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, snapshot)
    with torch.no_grad():
        for p, k in zip(tr.params, kept):
            p.copy_(k)
    ckpt.save_checkpoint(tr.out_dir, ckpt.MODEL_LATEST, params, opt_state, {"epoch": 3})
    jtr = JTrainer(jplan, JTrainConfig(), str(tmp_path / "jax"))
    tmpl_p = jax.tree_util.tree_map(jnp.asarray, _jax_params(jplan))
    tmpl_o = jtr.tx.init(tmpl_p)
    jp, jo, meta = jckpt.load_checkpoint(tr.out_dir, jckpt.MODEL_LATEST, tmpl_p, tmpl_o)
    assert meta == {"epoch": 3}
    _assert_tree_close(dict(zip(tr.names, tr.params)), jp, 0.0)
    _assert_tree_close(dict(zip(tr.names, tr.trace)), jo[2][0].trace, 0.0)

    rng = np.random.RandomState(5)
    trace = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), tmpl_p)
    saved_o = (tmpl_o[0], tmpl_o[1], (tmpl_o[2][0]._replace(trace=trace), tmpl_o[2][1]))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jckpt.MODEL_LATEST, tmpl_p, saved_o,
                          {"epoch": 1})
    p2, o2, meta2 = ckpt.load_checkpoint(str(tmp_path / "jax"), ckpt.MODEL_LATEST)
    assert meta2 == {"epoch": 1} and set(o2) == {"0", "1", "2"}
    tr.load_state_trees(p2, o2)
    _assert_tree_close(dict(zip(tr.names, tr.params)), tmpl_p, 0.0)
    _assert_tree_close(dict(zip(tr.names, tr.trace)), trace, 0.0)
    assert opt_state_tree({}) == {"0": {}, "1": {}, "2": {"0": {"trace": {}}, "1": {}}}


# ---------------------------------------------------------- the loop


def _blob_datasets(patch, n_cases=2, size=12):
    rng = np.random.RandomState(0)
    out = (JSegDataset(patch), SegDataset(patch))
    for i in range(n_cases):
        img = rng.rand(size, size, size).astype(np.float32)
        lbl = np.zeros((size, size, size), np.uint8)
        lbl[3:7, 3:7, 3:7] = 1
        for ds in out:
            ds.add_case("case%d" % i, img + 3.0 * lbl, lbl)
    return out


def _record_batches(ds, seen):
    sample = ds.sample_batch

    def recorded(rng, n, fg):
        imgs, lbls = sample(rng, n, fg)
        seen.append(imgs.tobytes() + lbls.tobytes())
        return imgs, lbls

    ds.sample_batch = recorded
    return ds


def test_trainer_resumes_a_jax_model_latest_like_jax(tmp_path):
    """The JAX Trainer and the port's (micro plan, bf16, augmentation off,
    noval, 3 epochs x 6 batches) each resume the same JAX-written
    model_latest at epoch 0: they draw the same batches, and their
    per-epoch mean losses agree within rtol 2e-2 (bf16 convolutions
    accumulate in another order, and 18 steps at momentum 0.99 carry the
    difference along)."""
    jplan, plan = micro_plan(JPlan), micro_plan()
    jcfg = JTrainConfig(epochs=3, batches_per_epoch=6, augment=False, noval=True)
    cfg = TrainConfig(epochs=3, batches_per_epoch=6, augment=False, noval=True)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr = JTrainer(jplan, jcfg, jdir)
    params, opt_state = jtr.init_state(jax.random.PRNGKey(7))
    for d in (jdir, tdir):
        jckpt.save_checkpoint(d, jckpt.MODEL_LATEST, params, opt_state, {"epoch": 0})
    jds, tds = _blob_datasets(jplan.patch_size)
    jseen, tseen = [], []
    jtr.fit(_record_batches(jds, jseen))
    tr = Trainer(plan, cfg, tdir, device="cpu")
    _, best = tr.fit(_record_batches(tds, tseen))
    assert len(tseen) == 18 and jseen == tseen
    assert best == 3.0 and [h["epoch"] for h in tr.history] == [1, 2, 3]
    want, got = (json.load(open(os.path.join(d, "model_latest.json"))) for d in (jdir, tdir))
    assert set(got) == set(want) and got["epoch"] == 3 and got["val_metric"] is None
    jlog = [float(line.split("loss=")[1].split()[0])
            for line in open(os.path.join(jdir, "training_log.txt")) if "loss=" in line]
    np.testing.assert_allclose([h["train_loss"] for h in tr.history], jlog, rtol=2e-2)
    assert all(np.isfinite(v) for h in tr.history for v in h["losses"])
    # noval: model_best holds the last epoch; a rerun resumes at the end
    assert json.load(open(os.path.join(tdir, "model_best.json")))["epoch"] == 3
    again = Trainer(plan, cfg, tdir, device="cpu")
    again.fit(tds)
    assert again.history == []


def test_trainer_validation_and_epoch_checkpoints(tmp_path):
    """With a validation set: the metric is hard Dice of val_batches
    batches, model_best is written only when it improves, every epoch
    leaves model_ep_%04d, augmentation runs (its generator seeded with the
    config's seed), and every loss is finite."""
    plan = micro_plan()
    _, tds = _blob_datasets(plan.patch_size)
    cfg = TrainConfig(epochs=2, batches_per_epoch=3, save_every_epoch=True, val_batches=2,
                      aug=augment.AugmentConfig(p_rotscale=1.0))
    tr = Trainer(plan, cfg, str(tmp_path), device="cpu")
    _, best = tr.fit(tds, tds)
    metrics = [h["metric"] for h in tr.history]
    assert all(0.0 <= m <= 1.0 for m in metrics) and best == max(metrics)
    for name in ("model_latest", "model_best", "model_ep_0001", "model_ep_0002"):
        assert ckpt.checkpoint_exists(str(tmp_path), name)
        params, _, meta = ckpt.load_checkpoint(str(tmp_path), name)
        assert ckpt.params_from_flax(params).keys() == tr.model.state_dict().keys()
    assert json.load(open(tmp_path / "model_best.json"))["val_metric"] == best
    assert all(np.isfinite(v) for h in tr.history for v in h["losses"])
    assert ckpt.load_checkpoint(str(tmp_path), "model_latest")[1] is not None
