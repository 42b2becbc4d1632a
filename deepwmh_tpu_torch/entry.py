"""Entry points of the port (the counterpart of the repository's
``__graft_entry__.py``).

entry()             -> (forward, (model, x)): the flagship 3D U-Net's
                       inference forward (``default_plan_1mm_iso()``, a bf16
                       128^3 patch, random weights from seed 0) on the card.
dryrun_multichip(n) -> this package's mesh paths on an n-shard CPU mesh
                       (``Mesh([cpu] * n)``) at the JAX dryrun's tiny shapes:
                       a data-parallel train step, the patch- and
                       flip-sharded sweeps, ``predict_case`` and a 3-case
                       burst on the mesh, the halo-sharded median and
                       z-score, ``mean_std_grid`` and N4,
                       ``register_pairs_mesh`` and the learned
                       registration's data-parallel training.

    python -c "from deepwmh_tpu_torch.entry import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations


def entry():
    import torch

    from deepwmh_tpu_torch.device import resolve_device
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso

    dev = resolve_device(None)
    plan = default_plan_1mm_iso()
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last_3d).eval()

    @torch.inference_mode()
    def forward(model, x):
        return model(x)

    x = torch.zeros((1, 1) + tuple(plan.patch_size), dtype=torch.bfloat16, device=dev)
    return forward, (model, x)


def dryrun_multichip(n_devices: int) -> None:
    import tempfile

    import numpy as np
    import torch

    from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor
    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.parallel.spatial import HaloShardedOps
    from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
    from deepwmh_tpu_torch.unet.plan import Plan

    mesh = Mesh([torch.device("cpu")] * n_devices, ("dp",))
    plan = Plan(
        target_spacing=[1.0, 1.0, 1.0],
        patch_size=[16, 16, 16],
        batch_size=n_devices,
        pool_kernels=[[2, 2, 2], [2, 2, 2]],
        conv_kernels=[[3, 3, 3], [3, 3, 3], [3, 3, 3]],
        base_features=4,
        max_features=16,
    )
    rng = np.random.RandomState(0)

    # one data-parallel train step: a batch row a shard, augmentation on
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    cfg = TrainConfig(epochs=1, batches_per_epoch=1, batch_size=n_devices, augment=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(plan, cfg, tmp, mesh=mesh)
        trainer.init_state(0)
        imgs = rng.rand(n_devices, 16, 16, 16).astype(np.float32)
        lbls = (rng.rand(n_devices, 16, 16, 16) > 0.8).astype(np.int32)
        loss = trainer.train_step(*trainer._to_device(imgs, lbls), trainer.lr_at(0),
                                  torch.Generator().manual_seed(1))
    print("dryrun_multichip(%d): train step ok, loss=%.4f" % (n_devices, float(loss)))

    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))

    # mesh-sharded sliding-window inference: patch blocks + psum merge
    pred = ShardedSlidingWindowPredictor(model, plan, mesh, tta=False, mode="patch")
    probs = pred.predict_volume(rng.rand(20, 18, 24).astype(np.float32))
    # the production default: whole-volume TTA, flips dealt over the mesh
    pred_fv = ShardedSlidingWindowPredictor(model, plan, mesh, tta=True, mode="fullvol")
    probs_fv = pred_fv.predict_volume(rng.rand(20, 18, 24).astype(np.float32))
    # the serve --mesh path: the case program around the sharded sweep
    seg_case, _fg_case = pred_fv.predict_case(
        rng.rand(18, 22, 16).astype(np.float32) * 100.0, (1.3, 0.9, 1.1))
    # the serve --mesh burst: one case a shard
    burst = pred_fv.predict_case_full_batch(
        rng.rand(3, 18, 22, 16).astype(np.float32) * 100.0, (1.3, 0.9, 1.1))
    print("dryrun_multichip(%d): sharded inference ok, patch %s fullvol %s case %s burst %s"
          % (n_devices, tuple(probs.shape), tuple(probs_fv.shape), tuple(seg_case.shape),
             tuple(burst[3].shape)))

    # halo-sharded whole-volume ops: neighbour exchange + psum'd statistics
    hops = HaloShardedOps(mesh)
    vol = torch.from_numpy(rng.rand(4 * n_devices, 10, 12).astype(np.float32))
    med = hops.median_filter(vol, 3)
    zs = hops.z_score(vol)
    print("dryrun_multichip(%d): halo-sharded ops ok, median %s zscore %s"
          % (n_devices, tuple(med.shape), tuple(zs.shape)))

    # stage-1's alignment grid and N4, spatially sharded
    mu, _sd = hops.mean_std_grid(vol, (6, 6, 6))
    n4vol = torch.from_numpy(
        (100.0 * (1.0 + 0.3 * rng.rand(4 * n_devices, 10, 12))).astype(np.float32))
    corr = hops.n4_bias_correction(n4vol, levels=1, iters_per_level=2)
    print("dryrun_multichip(%d): sharded mean_std_grid %s + N4 %s ok"
          % (n_devices, tuple(mu.shape), tuple(corr.shape)))

    # mesh-sharded pair registration: a block of pairs a shard
    from deepwmh_tpu_torch.registration.affine import AffineConfig
    from deepwmh_tpu_torch.registration.group import register_pairs_mesh
    from deepwmh_tpu_torch.registration.svf import SVFConfig

    fx = rng.rand(n_devices, 12, 14, 12).astype(np.float32)
    mv = rng.rand(n_devices, 12, 14, 12).astype(np.float32)
    mats, _, _, _, warped = register_pairs_mesh(
        fx, mv, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), mesh,
        affine_cfg=AffineConfig(shrinks=(2,), iters=(2,)),
        svf_cfg=SVFConfig(shrinks=(2,), iters=(2,)))
    print("dryrun_multichip(%d): mesh-sharded registration ok, mats %s warped %s"
          % (n_devices, tuple(mats.shape), tuple(warped.shape)))

    # the registration network's data-parallel training
    from deepwmh_tpu_torch.registration.learned import LearnedRegConfig, LearnedRegistration

    lreg = LearnedRegistration((8, 8, 8), LearnedRegConfig(
        base_features=2, max_features=4, num_pools=1, steps=1, batch_pairs=n_devices),
        device="cpu")
    vols = [rng.rand(8, 8, 8).astype(np.float32) * 100 for _ in range(3)]
    loss = lreg.train(vols, verbose=False, mesh=mesh)
    print("dryrun_multichip(%d): learned-reg dp training ok, loss %.4f" % (n_devices, loss))
