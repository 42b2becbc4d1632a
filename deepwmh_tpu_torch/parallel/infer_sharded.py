"""Mesh-sharded inference (port of ``deepwmh_tpu.parallel.infer_sharded``).

The single-device predictor's two modes, spread over a ``Mesh``:

- **Whole volume** (default when the padded volume fits
  ``FULLVOL_MAX_VOXELS``): the mirror-TTA flips are dealt to the shards in
  blocks of ``ceil(nf / n)``; each shard runs whole-volume forwards of its
  flips on the replicated volume (padding slots run nothing) and one
  ``psum``, divided by nf, merges the softmax sums. At n = 1 or n = nf the
  additions happen in the single sweep's order, so the result has its bits.
- **Patch sweep** (above ``FULLVOL_MAX_VOXELS`` or mode='patch'): the
  position list, bucketed to a multiple of ``POS_BUCKET * n``, is cut into
  n contiguous blocks; each shard sweeps its block with the shared
  ``accumulate_patches`` and the Gaussian accumulators are psum-merged.

A burst of B > 1 cases (``predict_case_full_batch``, the serve path) runs
one case a shard instead, each through the single-device sweep. Every
shard's forward runs the U-Net on K1's two kernels (on a card). Shards on
one device share its model; another card gets a copy of the weights.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from deepwmh_tpu_torch.parallel.mesh import Mesh, broadcast, psum, to_device
from deepwmh_tpu_torch.unet.infer import (
    SlidingWindowPredictor,
    accumulate_patches,
    flip_forward,
    fullvol_shape,
    patch_positions,
    sweep,
    use_fullvol,
)
from deepwmh_tpu_torch.unet.preprocess import pad_to, padded_shape


def build_fullvol_tta_sharded(replicas, num_classes: int, flips, mesh: Mesh):
    """The flip-sharded whole-volume TTA: shard d runs batch-1 forwards of
    flips d*fpd .. d*fpd + fpd - 1 with ``replicas[d]`` (the model on
    ``mesh.devices[d]``); padding slots skip the forward. Returns
    (fn(volume) -> f32 [D,H,W,C] on the first shard's device, tab, wts);
    the volume must be padded to the network stride."""
    n = mesh.size
    nf = len(flips)
    fpd = -(-nf // n)  # flips per shard (block assignment, padded)
    tab = np.zeros((n * fpd, 3), np.bool_)
    wts = np.zeros((n * fpd,), np.float32)
    for i, f in enumerate(flips):
        tab[i] = f
        wts[i] = 1.0

    def fn(volume):
        vols = broadcast(mesh, volume)
        shape = tuple(volume.shape) + (num_classes,)
        accs = [torch.zeros(shape, dtype=torch.float32, device=dev) for dev in mesh.devices]
        # slot-major, so every card has work queued before any waits
        for i in range(fpd):
            for d in range(n):
                slot = d * fpd + i
                if wts[slot] > 0:
                    flip = tuple(bool(f) for f in tab[slot])
                    accs[d] = accs[d] + flip_forward(replicas[d], vols[d][None], flip)[0]
        return psum(mesh, accs) / nf

    return fn, tab, wts


def _positions_for_mesh(image_size, patch_size, n_devices: int, step_fraction=0.5):
    return patch_positions(image_size, patch_size, step_fraction,
                           bucket_multiple=n_devices)


class ShardedSlidingWindowPredictor(SlidingWindowPredictor):
    """The single-device predictor with its sweep spread over ``mesh``
    (same ``mode`` semantics). predict_volume, predict_case,
    predict_case_full and predict_case_full_batch are inherited: only
    ``_sweep`` differs. ``device``: where the rest of the case program
    (N4, resampling, post-processing) runs and results land; the first
    shard's device by default."""

    def __init__(self, model, plan, mesh: Mesh, tta: bool = False, step_fraction=0.5,
                 mode: str = "auto", device=None):
        if not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deepwmh_tpu_torch.parallel.mesh.Mesh, got %r"
                            % (mesh,))
        super().__init__(model, plan, tta=tta, step_fraction=step_fraction, mode=mode,
                         device=mesh.devices[0] if device is None else device)
        # a mesh run is never pinned to one card
        self.pinned = False
        self.mesh = mesh
        models, gausses = {self.device: self.model}, {self.device: self.gauss}
        for dev in mesh.devices:
            if dev not in models:
                models[dev] = copy.deepcopy(self.model).to(dev)
                gausses[dev] = self.gauss.to(dev)
        self.replicas = [models[dev] for dev in mesh.devices]
        self._gauss = [gausses[dev] for dev in mesh.devices]

    def _sweep(self, vols):
        if vols.shape[0] > 1:
            return self._sweep_burst(vols)
        res_shape = tuple(vols.shape[1:])
        C = int(self.plan.num_classes)
        if use_fullvol(self.mode, res_shape, self.plan):
            fn, _, _ = build_fullvol_tta_sharded(self.replicas, C, self._flips(), self.mesh)
            probs = fn(pad_to(vols[0], fullvol_shape(res_shape, self.plan)))
        else:
            probs = self._patch_sweep(vols[0], res_shape)
        probs = to_device(probs, self.device)
        return probs[None, : res_shape[0], : res_shape[1], : res_shape[2]]

    def _patch_sweep(self, vol, res_shape):
        """Shard d sweeps the d-th contiguous block of the bucketed
        positions; the accumulators are psum-merged."""
        n = self.mesh.size
        target = padded_shape(res_shape, self.patch_size)
        pos, pos_w = _positions_for_mesh(target, self.patch_size, n, self.step_fraction)
        per = len(pos) // n
        vols = broadcast(self.mesh, pad_to(vol, target))
        accs, wts = [], []
        for d in range(n):
            block = slice(d * per, (d + 1) * per)
            acc, wt = accumulate_patches(self.replicas[d], vols[d], pos[block], pos_w[block],
                                         self._gauss[d], self.patch_size,
                                         int(self.plan.num_classes), self._flips())
            accs.append(acc)
            wts.append(wt)
        acc, wt = psum(self.mesh, accs), psum(self.mesh, wts)
        return acc / torch.clamp(wt, min=1e-8)[..., None]

    def _sweep_burst(self, vols):
        """One case a shard (case b on shard b mod n), each through the
        single-device sweep; results gathered on the predictor's device."""
        n = self.mesh.size
        out = []
        for b in range(vols.shape[0]):
            d = b % n
            vol = to_device(vols[b:b + 1], self.mesh.devices[d])
            out.append(sweep(self.replicas[d], vol, self.plan, self.mode, self._flips(),
                             self._gauss[d], self.step_fraction))
        return torch.cat([to_device(p, self.device) for p in out])
