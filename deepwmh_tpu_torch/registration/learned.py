"""Learned (VoxelMorph-style) registration, the amortised alternative (the
port of ``deepwmh_tpu.registration.learned``).

Train a small velocity-predicting U-Net (the port's ``UNet3D``, 2 input
channels [fixed, moving], 3 output channels) on a cohort of same-grid
volumes once, then register any pair with one forward pass: v = 1.5 *
tanh(net), warp = exp(v) by scaling-and-squaring. Loss = -LNCC(fixed,
moving o warp) + smooth_weight * |grad v|^2, with Adam (``utils/adam.py``).

Training runs the model with ``fused_norm`` off (K1's kernels have no
backward); ``register`` runs it on K1 under ``torch.inference_mode()``.
Pair draws are the JAX package's (``np.random.RandomState(rng_seed)``); the
initial weights are flax's distributions from a torch generator seeded with
``rng_seed`` (flax's own draws cannot be replayed: load them with
``load_flax_params`` to start from a JAX model). The winsorized cohort stays
on the device while it fits the budget (2 GiB, or
``DEEPWMH_REG_COHORT_HBM_BYTES``), else pairs are uploaded per step.

``train(mesh=)`` is data parallel, as JAX's over its 'dp' axis: shard d
takes a contiguous block of each step's pair batch on its own replica of
the network; the loss is the mean over pairs (the mean of the shards'
means), the shards' gradients are psum'd in shard order, Adam runs on the
home shard and the other replicas copy its parameters. The resident cohort
goes once to each distinct device; on the host route each shard's rows
go to its own device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.warp import displacement_warp
from deepwmh_tpu_torch.parallel.mesh import copy_params, psum, psum_grads, replicate, to_device
from deepwmh_tpu_torch.registration.similarity import grad_sq, lncc, winsorize_rescale
from deepwmh_tpu_torch.registration.svf import scaling_and_squaring
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan
from deepwmh_tpu_torch.utils.adam import Adam

@dataclass
class LearnedRegConfig:
    base_features: int = 8
    max_features: int = 32
    num_pools: int = 3
    steps: int = 300
    batch_pairs: int = 1
    lr: float = 1e-3
    smooth_weight: float = 1.0
    lncc_radius: int = 2
    int_steps: int = 5
    velocity_scale: float = 1.5  # tanh-bounded max velocity (voxels/step)


def _reg_plan(grid_shape, cfg: LearnedRegConfig) -> Plan:
    return Plan(
        target_spacing=[1.0, 1.0, 1.0],
        patch_size=[int(s) for s in grid_shape],
        batch_size=cfg.batch_pairs,
        pool_kernels=[[2, 2, 2]] * cfg.num_pools,
        conv_kernels=[[3, 3, 3]] * (cfg.num_pools + 1),
        base_features=cfg.base_features,
        max_features=cfg.max_features,
        num_classes=3,  # the 3 velocity components
        in_channels=2,
    )


def set_fused_norm(model: UNet3D, on: bool) -> None:
    """Run the model's blocks on K1 (inference) or on the plain chain that
    autograd differentiates (training)."""
    for blk in model.blocks:
        blk.fused_norm = on


class LearnedRegistration:
    """Train once on a cohort of same-grid volumes; register pairs in one
    forward pass. ``device``: CUDA unless the CPU is asked for."""

    def __init__(self, grid_shape, cfg: LearnedRegConfig = None, device=None):
        self.cfg = cfg or LearnedRegConfig()
        self.device = resolve_device(device)
        self.grid_shape = tuple(int(s) for s in grid_shape)
        # the U-Net needs every axis divisible by 2^num_pools; inputs are
        # zero-padded to this shape and the velocity cropped back
        stride = 2 ** self.cfg.num_pools
        self.pad_shape = tuple(-(-s // stride) * stride for s in self.grid_shape)
        self.plan = _reg_plan(self.pad_shape, self.cfg)
        self.model = UNet3D(self.plan, fused_norm=False).to(
            self.device, memory_format=torch.channels_last_3d)
        self.trained = False

    def load_flax_params(self, params_tree) -> None:
        """Weights from a flax parameter tree (the JAX model's)."""
        self.model.load_state_dict(ckpt.params_from_flax(params_tree), strict=True)
        self.trained = True

    # ------------------------------------------------------------------ #

    def _velocity(self, fixed, moving, model=None) -> torch.Tensor:
        """[B,D,H,W] pairs -> velocities [B,3,D,H,W] (``model``: a mesh
        shard's replica; ``self.model`` by default)."""
        D, H, W = self.grid_shape
        pads = []
        for p, s in zip(reversed(self.pad_shape), reversed(self.grid_shape)):
            pads += [0, p - s]
        x = F.pad(torch.stack([fixed, moving], dim=1), pads)
        out = (model or self.model)(x)  # [B, 3, pad D, H, W], f32
        return (torch.tanh(out.float()) * self.cfg.velocity_scale)[:, :, :D, :H, :W]

    def _predict(self, fixed, moving) -> torch.Tensor:
        """One winsorized pair on the device -> displacement [3,D,H,W]: the
        model on K1, then the integration."""
        set_fused_norm(self.model, True)
        try:
            with torch.inference_mode():
                v = self._velocity(fixed[None], moving[None])[0]
                return scaling_and_squaring(v, self.cfg.int_steps)
        finally:
            set_fused_norm(self.model, False)

    def _loss(self, fixed, moving, model=None) -> torch.Tensor:
        """Mean loss over a pair batch [B,D,H,W]."""
        v = self._velocity(fixed, moving, model)
        losses = []
        for b in range(v.shape[0]):
            disp = scaling_and_squaring(v[b], self.cfg.int_steps)
            warped = displacement_warp(moving[b], disp)
            losses.append(-lncc(fixed[b], warped, radius=self.cfg.lncc_radius)
                          + self.cfg.smooth_weight * grad_sq(v[b]))
        return torch.stack(losses).mean()

    def train_step(self, opt: Adam, fixed, moving) -> torch.Tensor:
        """One Adam step on a pair batch; returns the loss (not waited for)."""
        loss = self._loss(fixed, moving)
        # the deeper heads feed no loss: their gradient is zero, as in JAX
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(opt.params, grads)])
        return loss.detach()

    def replicas(self, mesh) -> list:
        """One network a local shard of ``mesh`` (``None`` for another
        process's), the home shard's being ``self.model``."""
        if mesh.home != self.device:
            raise ValueError("the network is on %s, the mesh's home shard on %s"
                             % (self.device, mesh.home))
        return replicate(mesh, self.model)

    def mesh_loss_grads(self, mesh, replicas, fixed, moving):
        """The mean loss over every shard's pairs and the gradient of every
        parameter (psum'd in shard order, on the home shard) from
        per-shard pair blocks."""
        n = mesh.size
        losses, grads = [None] * n, [None] * n
        for d in mesh.local_shards:
            loss = self._loss(fixed[d], moving[d], replicas[d]) / n
            grads[d] = torch.autograd.grad(loss, list(replicas[d].parameters()),
                                           allow_unused=True)
            losses[d] = loss.detach().reshape(1)
        return psum(mesh, losses)[0], psum_grads(mesh, grads, list(self.model.parameters()))

    def mesh_train_step(self, opt: Adam, mesh, replicas, fixed, moving) -> torch.Tensor:
        """One data-parallel Adam step (per-shard pair blocks); every
        replica holds the home network's parameters after it."""
        loss, grads = self.mesh_loss_grads(mesh, replicas, fixed, moving)
        opt.step(grads)
        copy_params(replicas, opt.params)
        return loss

    # ------------------------------------------------------------------ #

    def train(self, volumes, rng_seed: int = 0, verbose: bool = True, mesh=None) -> float:
        """volumes: list of [D,H,W] arrays on the common grid (affine
        aligned). ``cfg.steps`` Adam steps on random ordered pair batches;
        returns the mean loss of the last 20 steps. ``mesh``: data-parallel
        steps over its shards (``batch_pairs`` of 1 is raised to the mesh
        size; any other must divide by it)."""
        cfg = self.cfg
        B = max(int(cfg.batch_pairs), 1)
        if mesh is not None:
            if B == 1 and mesh.size > 1:
                B = mesh.size
                if verbose:
                    print("regnet: batch_pairs 1 -> %d (one pair per mesh device)" % B,
                          flush=True)
            elif B % mesh.size:
                raise ValueError("batch_pairs (%d) must divide by the mesh size (%d)"
                                 % (B, mesh.size))
        dev = self.device
        cohort_bytes = 4 * sum(int(np.prod(np.shape(v))) for v in volumes)
        max_resident = int(os.environ.get("DEEPWMH_REG_COHORT_HBM_BYTES", 2 << 30))
        resident = cohort_bytes <= max_resident
        if verbose and not resident:
            print("regnet: cohort %.1f GiB > %.1f GiB budget, batching from host"
                  % (cohort_bytes / 2**30, max_resident / 2**30), flush=True)
        wins = []
        for v in volumes:
            w = winsorize_rescale(torch.as_tensor(np.asarray(v, np.float32)).to(dev))
            wins.append(w if resident else w.cpu())
        # resident: the cohort once on every distinct device of the shards
        shard_devs = [dev] if mesh is None else [mesh.devices[d] for d in mesh.local_shards]
        cohort = {d: ([to_device(w, d) for w in wins] if resident else wins) for d in shard_devs}

        def gather(ia, ib, to):
            # resident: indexing on the device, no transfer; else one upload
            vols = cohort[to]
            return (torch.stack([vols[int(i)] for i in ia]).to(to),
                    torch.stack([vols[int(j)] for j in ib]).to(to))

        init_weights(self.model, torch.Generator().manual_seed(rng_seed))
        set_fused_norm(self.model, False)
        reps = None if mesh is None else self.replicas(mesh)
        opt = Adam(list(self.model.parameters()), cfg.lr)
        n_vols = len(volumes)
        np_rng = np.random.RandomState(rng_seed)
        losses = []
        for step in range(cfg.steps):
            idx = np_rng.randint(0, n_vols, size=(B, 2))
            idx[:, 1] = np.where(idx[:, 0] == idx[:, 1], (idx[:, 1] + 1) % n_vols, idx[:, 1])
            if mesh is None:
                losses.append(self.train_step(opt, *gather(idx[:, 0], idx[:, 1], dev)))
            else:
                rows = B // mesh.size
                fixed, moving = [None] * mesh.size, [None] * mesh.size
                for d in mesh.local_shards:
                    block = idx[d * rows:(d + 1) * rows]
                    fixed[d], moving[d] = gather(block[:, 0], block[:, 1], mesh.devices[d])
                losses.append(self.mesh_train_step(opt, mesh, reps, fixed, moving))
            if verbose and (step + 1) % max(cfg.steps // 10, 1) == 0:
                print("regnet step %d/%d loss %.4f"
                      % (step + 1, cfg.steps, float(torch.stack(losses[-20:]).mean())),
                      flush=True)
        self.trained = True
        return float(np.mean(torch.stack(losses[-20:]).cpu().numpy()))

    def register(self, fixed, moving) -> np.ndarray:
        """One forward pass -> displacement field [3,D,H,W] (voxel units)
        with moving o (id + disp) ~ fixed."""
        if not self.trained:
            raise RuntimeError("train() first (or load_flax_params)")
        dev = self.device
        f = winsorize_rescale(torch.as_tensor(np.asarray(fixed, np.float32)).to(dev))
        m = winsorize_rescale(torch.as_tensor(np.asarray(moving, np.float32)).to(dev))
        return self._predict(f, m).cpu().numpy()
