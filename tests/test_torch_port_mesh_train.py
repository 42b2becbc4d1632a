"""deepwmh_tpu_torch's device mesh on the training side, on the CPU:
data-parallel ``Trainer(mesh=)``, ``LearnedRegistration.train(mesh=)``,
``register_pairs_mesh`` and ``GroupRegistration.launch(mesh=)``, and the
dryrun's three training-side parts.

The port runs on ``Mesh([cpu] * n)``; the JAX package on the first n of
the 8 virtual devices of tests/conftest.py. Tolerances:

- the dp Trainer (f32) against the port's unsharded trainer: the augmented
  batches equal, loss rtol 1e-6, parameters and momentum within 1e-5 of
  their largest magnitude after two steps, every replica the same bits;
  against JAX's dp trainer (augmentation off, an f32 model): loss rtol
  1e-5, gradients, parameters and momentum within 1e-5 of their scale;
- the dp learned registration (the f32 network) against JAX's at the same
  parameters and batch: JAX's own bars (tests/test_learned_reg.py), loss
  rtol 1e-4, gradient cosine > 0.99, norm ratio 0.95-1.05; against the port
  unsharded in f32: loss rtol 1e-6, gradients within 1e-5 of their scale;
- ``register_pairs_mesh``: each shard's block bit-equal to
  ``_pair_core_batch`` on that block (a block of one: ``_pair_core``), every
  row within the one-pair bars of ``_pair_core``; ``launch(mesh=)`` over
  blocks of one byte-equal to ``launch()`` one by one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from deepwmh_tpu.registration import learned as jlearned
from deepwmh_tpu.unet import losses as jlosses
from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.plan import Plan as JPlan
from deepwmh_tpu.unet.train import TrainConfig as JTrainConfig
from deepwmh_tpu.unet.train import Trainer as JTrainer
from deepwmh_tpu_torch.parallel.mesh import Mesh
from deepwmh_tpu_torch.registration import group, learned
from deepwmh_tpu_torch.registration.affine import (
    AffineConfig,
    feasible_affine_cfg,
    spacing_tensor,
)
from deepwmh_tpu_torch.registration.svf import SVFConfig, _feasible_cfg
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

import chip_smoke
from test_torch_port_group import _one_pair_bars

CPU = torch.device("cpu")
PATCH = (16, 16, 16)
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny products single-threaded: the test workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cpu_mesh(n):
    return Mesh([CPU] * n)


def tiny_plan(cls=Plan, batch=BATCH):
    return cls(target_spacing=[2.0] * 3, patch_size=list(PATCH), batch_size=batch,
               pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
               base_features=4, max_features=8)


def _batch(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, *PATCH).astype(np.float32)
    labels = (images + 0.5 * rng.randn(n, *PATCH) > 1.0).astype(np.int32)
    return images, labels


def _scale_close(got, want, rel):
    """Every tensor of ``got`` within ``rel`` times the largest magnitude
    of ``want``."""
    scale = max(float(w.detach().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g.detach() - w.detach()).abs().max()) <= rel * scale


def _replicas_equal(tr):
    for rep in tr.replicas:
        assert all(torch.equal(a, b) for a, b in zip(rep.parameters(), tr.params))


# ------------------------------------------------------------ the trainer


@pytest.mark.parametrize("n", [2, 4])
def test_dp_trainer_matches_unsharded(n, tmp_path):
    """Two augmented f32 steps over n shards against the unsharded trainer
    from the same weights, batches and generator seeds."""
    cfg = TrainConfig(epochs=1, batches_per_epoch=2, batch_size=BATCH, augment=True)
    runs = {}
    for name, mesh in (("single", None), ("mesh", cpu_mesh(n))):
        tr = Trainer(tiny_plan(), cfg, str(tmp_path / name), device="cpu", dtype=torch.float32,
                     mesh=mesh)
        tr.init_state(0)
        imgs, lbls = tr._to_device(*_batch())
        aug = tr.augment(imgs, lbls, torch.Generator().manual_seed(7))
        if mesh is not None:
            assert len(tr.replicas) == n and tr.replicas[0] is tr.model
            assert all(a.shape[0] == BATCH // n for a in aug[0])
            aug = tuple(torch.cat(a) for a in aug)
        gen = torch.Generator().manual_seed(3)
        losses = []
        for step in range(2):
            losses.append(float(tr.train_step(*tr._to_device(*_batch(step)), tr.lr_at(step),
                                              gen)))
            if mesh is not None:
                _replicas_equal(tr)
        runs[name] = (aug, losses, tr)
    (aug_s, loss_s, tr_s), (aug_m, loss_m, tr_m) = runs["single"], runs["mesh"]
    assert torch.equal(aug_m[0], aug_s[0]) and torch.equal(aug_m[1], aug_s[1])
    np.testing.assert_allclose(loss_m, loss_s, rtol=1e-6)
    _scale_close(tr_m.params, tr_s.params, 1e-5)
    _scale_close(tr_m.trace, tr_s.trace, 1e-5)


def _jax_params(jplan, seed=1):
    x = jnp.zeros((1,) + PATCH + (1,), jnp.bfloat16)
    model = JUNet3D(plan=jplan, dtype=jnp.float32, remat=True, decompose_fullres=False)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"])


def _close_to_tree(port, names, jax_tree, rel):
    want = ckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, jax_tree))
    _scale_close([port[names.index(k)] for k in want], list(want.values()), rel)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_trainer_matches_jax(n, tmp_path):
    """Two steps of JAX's Trainer over Mesh(jax.devices()[:n]) (its loss on
    a dp-sharded batch and its optax chain, as _train_step_impl with
    augmentation off; an f32 model) against the port's over n CPU shards
    from the same weights and batches."""
    if jax.device_count() < n:
        pytest.skip("needs %d virtual JAX devices" % n)
    jplan, plan = tiny_plan(JPlan), tiny_plan()
    jcfg = JTrainConfig(augment=False, epochs=1, batches_per_epoch=2, batch_size=BATCH)
    jtr = JTrainer(jplan, jcfg, str(tmp_path / "jax"), mesh=JMesh(jax.devices()[:n], ("dp",)))
    jtr.model = JUNet3D(plan=jplan, dtype=jnp.float32, remat=True, decompose_fullres=False)
    params = jax.device_put(_jax_params(jplan), jtr.rep_sharding)
    opt_state = jtr.tx.init(params)
    tr = Trainer(plan, TrainConfig(augment=False, epochs=1, batches_per_epoch=2,
                                   batch_size=BATCH),
                 str(tmp_path / "port"), device="cpu", dtype=torch.float32, mesh=cpu_mesh(n))
    tr.load_state_trees(jax.tree_util.tree_map(np.asarray, params))
    def jloss(p, images, labels):
        outs = jtr.model.apply({"params": p}, images[..., None], deep_supervision=True)
        return jlosses.deep_supervision_loss(outs, labels, jplan.pool_kernels)

    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    tx_update = jax.jit(jtr.tx.update)
    for i in range(2):
        images, labels = _batch(i)
        want_loss, jgrads = value_and_grad(params, *jtr._put_batch(images, labels))
        lr = tr.lr_at(i)
        updates, opt_state = tx_update(jgrads, opt_state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(
            lambda u: u * np.float32(lr), updates))
        loss, grads = tr.mesh_loss_grads(*tr._to_device(images, labels))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        _close_to_tree(grads, tr.names, jgrads, 1e-5)
        tr.update(grads, lr)
        tr._sync_replicas()
        _close_to_tree(tr.params, tr.names, params, 1e-5)
        _close_to_tree(tr.trace, tr.names, opt_state[2][0].trace, 1e-5)
        _replicas_equal(tr)


@pytest.mark.parametrize("batch,shards,line", [
    (2, 4, "batch 2 not divisible by mesh size 4: sharding over 2 device(s)"),
    (3, 2, "batch 3 not divisible by mesh size 2: running unsharded"),
])
def test_batch_the_mesh_does_not_divide(batch, shards, line, tmp_path, capsys):
    """JAX's rule and log line: a submesh of gcd(B, n) shards, or none."""
    cfg = TrainConfig(epochs=1, batches_per_epoch=1, batch_size=batch)
    tr = Trainer(tiny_plan(batch=batch), cfg, str(tmp_path / "port"), device="cpu",
                 mesh=cpu_mesh(shards))
    got = capsys.readouterr().out
    JTrainer(tiny_plan(JPlan, batch=batch), JTrainConfig(epochs=1, batches_per_epoch=1,
                                                        batch_size=batch),
             str(tmp_path / "jax"), mesh=JMesh(jax.devices()[:shards], ("dp",)))
    want = capsys.readouterr().out
    assert line in got and line in want
    if "unsharded" in line:
        assert tr.mesh is None and tr.replicas is None
    else:
        assert tr.mesh.size == 2 and len(tr.replicas) == 2


def test_dp_eval_step_is_the_batch_hard_dice(tmp_path):
    """Validation over the mesh psums the hard-Dice sums: the unsharded
    metric of the same batch."""
    cfg = TrainConfig(epochs=1, batches_per_epoch=1, batch_size=BATCH)
    single = Trainer(tiny_plan(), cfg, str(tmp_path / "a"), device="cpu", dtype=torch.float32)
    single.init_state(4)
    sharded = Trainer(tiny_plan(), cfg, str(tmp_path / "b"), device="cpu", dtype=torch.float32,
                      mesh=cpu_mesh(4))
    sharded.load_state_trees(*single.state_trees())
    images, labels = _batch(5)
    labels = (labels | (images > 0.0)).astype(np.int32)  # a prediction that overlaps
    want = float(single.eval_step(*single._to_device(images, labels)))
    got = float(sharded.eval_step(*sharded._to_device(images, labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mesh_and_one_card_runs_resume_each_other(tmp_path, capsys):
    """model_latest of a mesh run resumes on one device and the other way
    round: the checkpoint layout does not depend on the mesh."""
    from deepwmh_tpu_torch.unet.data import SegDataset

    ds = SegDataset(list(PATCH))
    for i in range(2):
        images, labels = _batch(10 + i, n=1)
        ds.add_case("c%d" % i, images[0], labels[0].astype(np.float32))
    for first, second in ((cpu_mesh(2), None), (None, cpu_mesh(2))):
        out = str(tmp_path / ("from_mesh" if first is not None else "from_one"))
        for epochs, mesh in ((1, first), (2, second)):
            cfg = TrainConfig(epochs=epochs, batches_per_epoch=1, batch_size=2, noval=True,
                              augment=False)
            tr = Trainer(tiny_plan(batch=2), cfg, out, device="cpu", mesh=mesh)
            tr.fit(ds)
        assert "resumed from model_latest at epoch 1" in capsys.readouterr().out
        assert [h["epoch"] for h in tr.history] == [2]
        _, _, meta = ckpt.load_checkpoint(out, ckpt.MODEL_LATEST)
        assert meta["epoch"] == 2


# ------------------------------------------------- learned registration

GRID = (16, 16, 16)
# one squaring step: JAX's compile time grows with the unrolled squarings,
# and the data parallelism under test does not depend on them
LEARNED = dict(base_features=4, max_features=8, num_pools=2, lr=3e-3, int_steps=1)


def _cohort(n=4):
    from deepwmh_tpu_torch.registration.priors import synthetic_atlas

    return [np.roll(synthetic_atlas(GRID, (2.0, 2.0, 2.0), seed=i)[0], i - 1, axis=0)
            for i in range(n)]


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float32).ravel() for g in grads])


def _pair_blocks(reg, mesh, fixed, moving):
    rows = fixed.shape[0] // mesh.size
    return ([torch.from_numpy(fixed[d * rows:(d + 1) * rows]) for d in range(mesh.size)],
            [torch.from_numpy(moving[d * rows:(d + 1) * rows]) for d in range(mesh.size)])


def test_dp_learned_loss_and_gradient_match_jax():
    """JAX's dp loss and gradient (its _loss over a pair batch sharded over
    two devices; the f32 network in both packages) against the port's over
    two CPU shards, with the same parameters: JAX's own bars for its dp
    path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 2
    vols = [np.asarray(jlearned.winsorize_rescale(jnp.asarray(v))) for v in _cohort()]
    fixed, moving = np.stack(vols[:2]), np.stack(vols[2:])
    jreg = jlearned.LearnedRegistration(GRID, jlearned.LearnedRegConfig(**LEARNED,
                                                                       batch_pairs=n))
    jreg.model = JUNet3D(plan=jreg.plan, dtype=jnp.float32)
    params = jax.jit(jreg.model.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1,) + GRID + (2,), jnp.float32))["params"]
    jm = JMesh(jax.devices()[:n], ("dp",))
    dp, rep = NamedSharding(jm, P("dp")), NamedSharding(jm, P())
    jloss, jgrads = jax.jit(jax.value_and_grad(jreg._loss))(
        jax.device_put(params, rep), jax.device_put(fixed, dp), jax.device_put(moving, dp))

    reg = _f32_reg(n)
    reg.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    mesh = cpu_mesh(n)
    loss, grads = reg.mesh_loss_grads(mesh, reg.replicas(mesh), *_pair_blocks(
        reg, mesh, fixed, moving))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    want = ckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    names = [k for k, _ in reg.model.named_parameters()]
    g1 = _flat([want[k] for k in names])
    gm = _flat([g.detach() for g in grads])
    cos = float(g1 @ gm / (np.linalg.norm(g1) * np.linalg.norm(gm) + 1e-12))
    ratio = float(np.linalg.norm(gm) / max(np.linalg.norm(g1), 1e-12))
    assert cos > 0.99, cos
    assert 0.95 < ratio < 1.05, ratio


def _f32_reg(batch_pairs, steps=1):
    reg = learned.LearnedRegistration(GRID, learned.LearnedRegConfig(
        **LEARNED, batch_pairs=batch_pairs, steps=steps), device="cpu")
    reg.model = init_weights(UNet3D(reg.plan, dtype=torch.float32, fused_norm=False),
                             torch.Generator().manual_seed(0)).to(
        memory_format=torch.channels_last_3d)
    return reg


@pytest.mark.parametrize("n", [2, 4])
def test_dp_learned_matches_unsharded_f32(n):
    """The f32 network: the mean loss over n shards and its gradient equal
    the unsharded batch's (loss rtol 1e-6, gradients within 1e-5 of their
    scale), and a one-step train() over the mesh gives the unsharded loss."""
    vols = [learned.winsorize_rescale(torch.from_numpy(v)) for v in _cohort()]
    fixed = torch.stack((vols[:2] * 2)[:n] if n == 2 else vols[:2] * 2)
    moving = torch.stack((vols[2:] * 2)[:n] if n == 2 else vols[2:] * 2)
    single, sharded = _f32_reg(n), _f32_reg(n)
    sharded.model.load_state_dict(single.model.state_dict())
    want_loss = single._loss(fixed, moving)
    want = torch.autograd.grad(want_loss, list(single.model.parameters()), allow_unused=True)
    want = [torch.zeros_like(p) if g is None else g
            for p, g in zip(single.model.parameters(), want)]
    mesh = cpu_mesh(n)
    loss, grads = sharded.mesh_loss_grads(mesh, sharded.replicas(mesh), *_pair_blocks(
        sharded, mesh, fixed.numpy(), moving.numpy()))
    np.testing.assert_allclose(float(loss), float(want_loss.detach()), rtol=1e-6)
    _scale_close(grads, want, 1e-5)

    cohort = _cohort()
    a = _f32_reg(1).train(cohort, rng_seed=2, verbose=False, mesh=cpu_mesh(n))
    b = _f32_reg(n).train(cohort, rng_seed=2, verbose=False)
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_learned_batch_pairs_rules_and_host_route(monkeypatch, capsys):
    """batch_pairs 1 is raised to the mesh size (JAX's line); one that does
    not divide raises; the host-batch route (a budget forced below the
    cohort) uploads each shard's rows and gives the resident route's loss."""
    cohort = _cohort(3)
    mesh = cpu_mesh(2)
    resident = _f32_reg(1, steps=2).train(cohort, verbose=True, mesh=mesh)
    assert "regnet: batch_pairs 1 -> 2 (one pair per mesh device)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="divide"):
        _f32_reg(3).train(cohort, verbose=False, mesh=mesh)
    monkeypatch.setenv("DEEPWMH_REG_COHORT_HBM_BYTES", "1")
    host = _f32_reg(2, steps=2).train(cohort, verbose=True, mesh=mesh)
    assert "batching from host" in capsys.readouterr().out
    assert host == resident


# ------------------------------------------------------ pair registration

PAIR_SHAPE = (24, 26, 22)
ACFG = AffineConfig(shrinks=(2,), iters=(3,))
SCFG = SVFConfig(shrinks=(2,), iters=(3,))
# a short affine schedule for the one-pair bars: at ACFG's 3 iterations these
# random-noise pairs are chaotic (a one-ulp input change moves either
# package's matrix by 0.77-2.32), so a batch row parts from its pair alone
# as a last-bit change does (test_batch_rows_within_the_one_ulp_spread)
SHORT_ACFG = AffineConfig(shrinks=(2,), iters=(1,))


@pytest.fixture(scope="module")
def pairs():
    """Five random pairs and their one-by-one _pair_core outputs on the
    short schedule."""
    rng = np.random.RandomState(0)
    fx = (rng.rand(5, *PAIR_SHAPE) * 100).astype(np.float32)
    mv = (rng.rand(5, *PAIR_SHAPE) * 100).astype(np.float32)
    sp = spacing_tensor((1.0, 1.0, 1.0), CPU)
    acfg, scfg = feasible_affine_cfg(SHORT_ACFG, PAIR_SHAPE), _feasible_cfg(SCFG, PAIR_SHAPE)
    one = [group._to_host(group._pair_core(
        torch.from_numpy(fx[i].astype(np.float16)), torch.from_numpy(mv[i].astype(np.float16)),
        sp, sp, acfg, scfg, True)) for i in range(5)]
    return fx, mv, one


@pytest.mark.parametrize("n", [2, 4])
def test_register_pairs_mesh_is_one_by_one(n, pairs):
    """B = 5 over n shards (the padding path): JAX's tuple layout; each
    shard's block of rows (the last pair repeated to fill it) bit-equal to
    one ``_pair_core_batch`` of that block on one device; on the short
    schedule every row within the one-pair bars of ``_pair_core`` one by
    one (a batch sums its products in another order than one pair, so its
    last bits differ)."""
    fx, mv, one = pairs
    got = group.register_pairs_mesh(fx, mv, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), cpu_mesh(n),
                                    affine_cfg=ACFG, svf_cfg=SCFG)
    assert [g.shape for g in got] == [(5, 3, 4), (5,), (5, 3) + PAIR_SHAPE, (5,),
                                      (5,) + PAIR_SHAPE]
    rows = -(-5 // n)
    padded = [np.concatenate([a, np.repeat(a[-1:], rows * n - 5, axis=0)]).astype(np.float16)
              for a in (fx, mv)]
    sp = spacing_tensor((1.0, 1.0, 1.0), CPU)
    acfg, scfg = feasible_affine_cfg(ACFG, PAIR_SHAPE), _feasible_cfg(SCFG, PAIR_SHAPE)
    for d in range(-(-5 // rows)):  # the shards that hold a pair
        lo, hi = d * rows, min((d + 1) * rows, 5)
        block = group._to_host(group._pair_core_batch(
            *(torch.from_numpy(a[d * rows:(d + 1) * rows]) for a in padded), sp, sp, acfg, scfg,
            True))
        for k in range(5):
            np.testing.assert_array_equal(got[k][lo:hi], block[k][:hi - lo])
    short = group.register_pairs_mesh(fx, mv, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), cpu_mesh(n),
                                      affine_cfg=SHORT_ACFG, svf_cfg=SCFG)
    for i in range(5):
        _one_pair_bars(tuple(g[i] for g in short), one[i], fx[i])
    affine_only = group.register_pairs_mesh(fx[:2], mv[:2], (1.0,) * 3, (1.0,) * 3, cpu_mesh(n),
                                            affine_cfg=ACFG, svf_cfg=SCFG, deformable=False)
    assert affine_only[2] is None and affine_only[3] is None
    # the matrices of the same blocks with the deformable stage
    both = group.register_pairs_mesh(fx[:2], mv[:2], (1.0,) * 3, (1.0,) * 3, cpu_mesh(n),
                                     affine_cfg=ACFG, svf_cfg=SCFG)
    np.testing.assert_array_equal(affine_only[0], both[0])


@pytest.mark.slow
def test_batch_rows_within_the_one_ulp_spread(pairs):
    """Why the one-pair bars run on SHORT_ACFG: at ACFG's 3 affine
    iterations each batch row of the 2-shard mesh (blocks of 3) parts from
    its pair alone by less in the matrix than a one-ulp change of the
    moving volume moves JAX's own ``_pair_core_jit`` on that pair."""
    from deepwmh_tpu.registration import affine as jaffine
    from deepwmh_tpu.registration import group as jgroup
    from deepwmh_tpu.registration import svf as jsvf

    fx, mv, _ = pairs
    got = group.register_pairs_mesh(fx, mv, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), cpu_mesh(2),
                                    affine_cfg=ACFG, svf_cfg=SCFG)
    sp = spacing_tensor((1.0, 1.0, 1.0), CPU)
    acfg, scfg = feasible_affine_cfg(ACFG, PAIR_SHAPE), _feasible_cfg(SCFG, PAIR_SHAPE)
    jacfg = jaffine.feasible_affine_cfg(jaffine.AffineConfig(shrinks=(2,), iters=(3,)), PAIR_SHAPE)
    jscfg = jsvf._feasible_cfg(jsvf.SVFConfig(shrinks=(2,), iters=(3,)), PAIR_SHAPE)
    jsp = jnp.ones(3, jnp.float32)
    for i in range(5):
        f16, m16 = fx[i].astype(np.float16), mv[i].astype(np.float16)
        up = np.nextafter(m16, np.float16(np.inf))
        port = [group._to_host(group._pair_core(torch.from_numpy(f16), torch.from_numpy(m),
                                                sp, sp, acfg, scfg, True))[0] for m in (m16, up)]
        ref = [np.asarray(jgroup._pair_core_jit(jnp.asarray(f16), jnp.asarray(m), jsp, jsp,
                                                jacfg, jscfg, deformable=True)[0])
               for m in (m16, up)]
        batch_gap = np.abs(got[0][i] - port[0]).max()
        ulp = {"port": np.abs(port[1] - port[0]).max(), "jax": np.abs(ref[1] - ref[0]).max()}
        print("pair %d: batch row - pair alone %.4g; one ulp moves the port %.4g, JAX %.4g"
              % (i, batch_gap, ulp["port"], ulp["jax"]))
        assert batch_gap < ulp["jax"]


def test_launch_over_a_mesh_writes_the_one_by_one_bytes(tmp_path, monkeypatch):
    """launch(mesh=) on a 2 x 2 cohort (one chunk of 4 over 4 shards: a
    block of one a shard, cut schedules): every artifact byte-equal to
    launch(batch_pairs=1)'s, one by one; a re-run skips all four; a warm
    start over a mesh raises JAX's ValueError."""
    src, tgt, cases = chip_smoke.registration_cohort(str(tmp_path / "cohort"), PAIR_SHAPE,
                                                     (1.0, 1.0, 1.0), n_targets=2, seed=0)
    sources = [(c, cases[c][0]) for c in ("src0", "src1")]
    targets = [(c, cases[c][0]) for c in ("tgt0", "tgt1")]
    chunks = []
    real = group.register_pairs_mesh
    monkeypatch.setattr(group, "register_pairs_mesh",
                        lambda f, *a, **kw: chunks.append(f.shape[0]) or real(f, *a, **kw))
    outs = {}
    for name, mesh, batch_pairs in (("one", None, 1), ("mesh", cpu_mesh(4), 4)):
        reg = group.GroupRegistration(sources, targets, str(tmp_path / name), quick=True,
                                      device="cpu")
        reg.affine_cfg, reg.svf_cfg = ACFG, SCFG
        reg.launch(verbose=False, batch_pairs=batch_pairs, mesh=mesh)
        outs[name] = reg
    assert chunks == [4]
    files = sorted(os.path.relpath(os.path.join(d, f), str(tmp_path / "one"))
                   for d, _, fs in os.walk(str(tmp_path / "one")) for f in fs)
    assert len(files) == 4 * 3
    for rel in files:
        with open(os.path.join(str(tmp_path / "one"), rel), "rb") as a, \
                open(os.path.join(str(tmp_path / "mesh"), rel), "rb") as b:
            assert a.read() == b.read(), rel
    outs["mesh"].launch(verbose=False, batch_pairs=4, mesh=cpu_mesh(4))
    assert chunks == [4]
    warm = group.GroupRegistration(sources, targets, str(tmp_path / "warm"), warm_start=True,
                                   device="cpu")
    with pytest.raises(ValueError, match="warm_start"):
        warm.launch(mesh=cpu_mesh(2))


# ------------------------------------------------------------- the dryrun


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_runs_the_training_side(n, capsys):
    from deepwmh_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n)
    out = capsys.readouterr().out
    for line in ("dryrun_multichip(%d): train step ok" % n,
                 "dryrun_multichip(%d): mesh-sharded registration ok, mats (%d, 3, 4)" % (n, n),
                 "dryrun_multichip(%d): learned-reg dp training ok" % n):
        assert line in out, out
