"""Entry points of the port (the counterpart of the repository's
``__graft_entry__.py``).

entry()             -> (forward, (model, x)): the flagship 3D U-Net's
                       inference forward (``default_plan_1mm_iso()``, a bf16
                       128^3 patch, random weights from seed 0) on the card.
dryrun_multichip(n) -> this package's mesh paths on an n-shard CPU mesh
                       (``Mesh([cpu] * n)``) at the JAX dryrun's tiny shapes:
                       the patch- and flip-sharded sweeps, ``predict_case``
                       and a 3-case burst on the mesh, the halo-sharded
                       median and z-score, ``mean_std_grid`` and N4.

The JAX dryrun also runs a data-parallel train step, ``register_pairs_mesh``
and the learned registration's data-parallel training; those mesh paths are
ROADMAP A13's second half and not in this dryrun yet.

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
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)

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
