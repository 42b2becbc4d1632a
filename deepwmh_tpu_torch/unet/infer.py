"""3D U-Net inference: whole-volume mirror TTA by default, the Gaussian
half-overlap patch sweep above ``FULLVOL_MAX_VOXELS`` (port of
``deepwmh_tpu.unet.infer``).

The two modes give different outputs (whole-volume instance-norm statistics
versus per-patch ones, no overlap averaging), so the routing threshold is
the JAX package's, kept for parity. Mirror TTA averages the f32 softmax over
the 8 axis-flip combinations. Probabilities are returned in the JAX layout
[D, H, W, C].
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.brain import brain_extract
from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
from deepwmh_tpu_torch.ops.n4 import n4_bias_correction
from deepwmh_tpu_torch.unet.preprocess import (
    pad_to,
    padded_shape,
    preprocess_case,
    resample_to_shape,
)

POS_BUCKET = 8
ALL_FLIPS = tuple(itertools.product((False, True), repeat=3))
NO_FLIPS = ((False, False, False),)
# above this many padded voxels the patch sweep takes over (the JAX
# package's threshold; the two modes differ numerically)
FULLVOL_MAX_VOXELS = 16_000_000


def gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8.0):
    """Separable Gaussian bump centred in the patch, max-normalised to 1 and
    floored at 1e-4 (the nnU-Net importance map), f32 [d, h, w]."""
    gs = []
    for s in patch_size:
        c = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        x = np.arange(s, dtype=np.float64)
        gs.append(np.exp(-0.5 * ((x - c) / sigma) ** 2))
    g = gs[0][:, None, None] * gs[1][None, :, None] * gs[2][None, None, :]
    g = np.maximum(g / g.max(), 1e-4)
    return torch.from_numpy(g.astype(np.float32))


def compute_steps(image_size, patch_size, step_fraction: float = 0.5):
    """Evenly spaced patch start positions per axis (nnU-Net step rule)."""
    steps = []
    for size, patch in zip(image_size, patch_size):
        size, patch = int(size), int(patch)
        if size <= patch:
            steps.append([0])
            continue
        target = patch * step_fraction
        num = int(math.ceil((size - patch) / target)) + 1
        actual = (size - patch) / max(num - 1, 1)
        steps.append([int(round(i * actual)) for i in range(num)])
    return steps


def patch_positions(image_size, patch_size, step_fraction: float = 0.5,
                    bucket_multiple: int = 1):
    """All patch start positions (int32 [P, 3]) and their weights (f32
    [P]), padded to a POS_BUCKET * bucket_multiple multiple by repeating
    the last position with weight 0, as the JAX sweep buckets them (a
    mesh of n shards passes n, so each shard takes an equal block)."""
    steps = compute_steps(image_size, patch_size, step_fraction)
    pos = np.array(list(itertools.product(*steps)), dtype=np.int32)
    n_real = len(pos)
    unit = POS_BUCKET * bucket_multiple
    bucket = int(math.ceil(n_real / unit) * unit)
    if bucket > n_real:
        pos = np.concatenate([pos, np.repeat(pos[-1:], bucket - n_real, axis=0)])
    w = np.zeros(bucket, np.float32)
    w[:n_real] = 1.0
    return pos, w


def _flip_axes(flip):
    return tuple(a for a, f in enumerate(flip) if f)


def flip_forward(model, volumes, flip):
    """One TTA forward of a batch [N,D,H,W]: flip, forward, f32 softmax,
    flip back. Returns [N, D, H, W, C]."""
    axes = tuple(a + 1 for a in _flip_axes(flip))
    v = volumes.flip(axes) if axes else volumes
    logits = model(v[:, None])
    p = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 4, 1)
    return p.flip(axes) if axes else p


def fullvol_tta(model, volume, num_classes: int, flips):
    """Whole-volume TTA: the mean softmax over ``flips``, [D, H, W, C] for
    one volume [D,H,W], or [N, D, H, W, C] for a batch [N,D,H,W] (one
    forward of the whole batch per flip; instance norm keeps the samples
    apart)."""
    vols = volume if volume.dim() == 4 else volume[None]
    acc = torch.zeros(tuple(vols.shape) + (num_classes,), dtype=torch.float32,
                      device=vols.device)
    for flip in flips:
        acc = acc + flip_forward(model, vols, flip)
    acc = acc / len(flips)
    return acc if volume.dim() == 4 else acc[0]


def _patch_forward(model, patch, flips):
    """All flips of one patch as one batched forward; mean softmax
    [d, h, w, C]."""
    xs = []
    for flip in flips:
        axes = _flip_axes(flip)
        xs.append(patch.flip(axes) if axes else patch)
    logits = model(torch.stack(xs)[:, None])
    probs = torch.softmax(logits.float(), dim=1)
    total = 0.0
    for i, flip in enumerate(flips):
        axes = _flip_axes(flip)
        p = probs[i].permute(1, 2, 3, 0)
        total = total + (p.flip(axes) if axes else p)
    return total / len(flips)


def accumulate_patches(model, volume, positions, pos_weights, gauss, patch_size,
                       num_classes: int, flips):
    """The patch sweep over padded [D,H,W]: UN-normalised Gaussian-weighted
    accumulators (acc [D,H,W,C], wt [D,H,W]). The binary case accumulates
    only the fg channel and rebuilds bg = wt - fg at the end. Zero-weight
    positions contribute nothing and are skipped."""
    D, H, W = volume.shape
    fg_only = num_classes == 2
    dev = volume.device
    acc = torch.zeros((D, H, W) if fg_only else (D, H, W, num_classes),
                      dtype=torch.float32, device=dev)
    wt = torch.zeros((D, H, W), dtype=torch.float32, device=dev)
    for pos, w in zip(np.asarray(positions).tolist(), np.asarray(pos_weights).tolist()):
        if w <= 0:
            continue
        sl = tuple(slice(p, p + s) for p, s in zip(pos, patch_size))
        probs = _patch_forward(model, volume[sl], flips)
        g = gauss * w
        if fg_only:
            acc[sl] = acc[sl] + g * probs[..., 1]
        else:
            acc[sl] = acc[sl] + g[..., None] * probs
        wt[sl] = wt[sl] + g
    if fg_only:
        acc = torch.stack([wt - acc, acc], dim=-1)
    return acc, wt


def fullvol_shape(shape, plan):
    """Pad each axis up to a multiple of the network's total stride."""
    strides = [1, 1, 1]
    for pk in plan.pool_kernels:
        for a in range(3):
            strides[a] *= int(pk[a])
    return tuple(int(-(-int(s) // st) * st) for s, st in zip(shape, strides))


def sweep(model, vols, plan, mode: str, flips, gauss, step_fraction: float = 0.5):
    """Softmax [B,D,H,W,C] of preprocessed ``vols`` [B,D,H,W] (unpadded) on
    their device: whole-volume TTA over the batch at once, or the patch
    sweep case by case (``gauss`` on the same device)."""
    res_shape = tuple(vols.shape[1:])
    C = int(plan.num_classes)
    if use_fullvol(mode, res_shape, plan):
        probs = fullvol_tta(model, pad_to(vols, fullvol_shape(res_shape, plan)), C, flips)
    else:
        patch_size = tuple(int(p) for p in plan.patch_size)
        target = padded_shape(res_shape, patch_size)
        pos, pos_w = patch_positions(target, patch_size, step_fraction)
        out = []
        for vol in vols:
            acc, wt = accumulate_patches(model, pad_to(vol, target), pos, pos_w, gauss,
                                         patch_size, C, flips)
            out.append(acc / torch.clamp(wt, min=1e-8)[..., None])
        probs = torch.stack(out)
    return probs[:, : res_shape[0], : res_shape[1], : res_shape[2]]


def use_fullvol(mode: str, res_shape, plan) -> bool:
    """'patch' forces the sweep; 'fullvol' forces whole-volume (raising
    above FULLVOL_MAX_VOXELS); 'auto' picks whole-volume when it fits."""
    if mode == "patch":
        return False
    vox = int(np.prod(fullvol_shape(res_shape, plan)))
    if mode == "fullvol":
        if vox > FULLVOL_MAX_VOXELS:
            raise ValueError(
                "volume %s exceeds FULLVOL_MAX_VOXELS; use mode='auto'" % (res_shape,))
        return True
    return vox <= FULLVOL_MAX_VOXELS


class SlidingWindowPredictor:
    """The user-facing predictor: owns the model on its device.

    mode: 'auto' (default) runs whole-volume inference when the padded
    volume fits (FULLVOL_MAX_VOXELS) and the Gaussian patch sweep above
    that; 'patch' / 'fullvol' force one. ``device``: CUDA by default; the
    CPU only when asked for."""

    def __init__(self, model, plan, tta: bool = True, step_fraction: float = 0.5,
                 mode: str = "auto", device=None):
        if int(plan.num_classes) != 2:
            # the case pipeline (fg>0.5 threshold, spark removal, FOV mask)
            # is binary-segmentation semantics
            raise ValueError(
                "case inference is binary (background+lesion); plan has "
                "num_classes=%d" % plan.num_classes)
        self.device = resolve_device(device)
        # a run pinned to one device (-g i / --device) never spreads N4
        # over the other cards (ops/n4.n4_would_shard)
        self.pinned = device is not None
        self.model = model.to(self.device, memory_format=torch.channels_last_3d).eval()
        self.plan = plan
        self.tta = tta
        self.step_fraction = step_fraction
        self.mode = mode
        self.patch_size = tuple(int(p) for p in plan.patch_size)
        self.gauss = gaussian_importance_map(self.patch_size).to(self.device)

    def _flips(self):
        return ALL_FLIPS if self.tta else NO_FLIPS

    def _tensor(self, data):
        if not torch.is_tensor(data):
            data = torch.from_numpy(np.array(data, dtype=np.float32, order="C"))
        return data.to(self.device, torch.float32)

    def _sweep(self, vols):
        """Softmax [B,D,H,W,C] of preprocessed ``vols`` [B,D,H,W] (unpadded).
        The one override point of the sweep: everything around it
        (predict_volume, predict_case, predict_case_full[_batch]) is shared
        with the mesh-sharded predictor (``parallel/infer_sharded.py``)."""
        return sweep(self.model, vols, self.plan, self.mode, self._flips(), self.gauss,
                     self.step_fraction)

    @torch.inference_mode()
    def predict_volume(self, volume):
        """volume: preprocessed [D,H,W] at plan spacing -> softmax [D,H,W,C]."""
        return self._sweep(self._tensor(volume)[None])[0]

    def _cases(self, vols, spacing):
        """Preprocess each of ``vols`` (same shape), sweep them together,
        resample each fg back and threshold. ``spacing`` is already rounded
        to 4 decimals; the resampled shape is round(shape * spacing /
        target_spacing) per axis (Python round). Returns [(seg, fg)]."""
        pre = torch.stack([preprocess_case(v, spacing, self.plan) for v in vols])
        fg = self._sweep(pre)[..., 1]
        out = []
        for vol, f in zip(vols, fg):
            fg_orig = resample_to_shape(f, tuple(vol.shape), order=1)
            out.append(((fg_orig > 0.5).to(torch.uint8), fg_orig))
        return out

    @torch.inference_mode()
    def predict_case(self, data, spacing, apply_n4: bool = False):
        """Raw volume + spacing -> (segmentation uint8, fg probability f32),
        both in the original grid, on the predictor's device."""
        spacing_r = tuple(round(float(s), 4) for s in spacing)
        vol = self._tensor(data)
        if apply_n4:
            vol = n4_bias_correction(vol)
        return self._cases([vol], spacing_r)[0]

    def _full(self, raws, spacing, apply_n4):
        """(pre, seg_raw, seg_3mm, seg_fov, fg) of each raw volume; the
        U-Net sweep runs over all of them at once."""
        spacing_r = tuple(round(float(s), 4) for s in spacing)
        pres = [n4_bias_correction(raw) if apply_n4 else raw for raw in raws]
        out = []
        for pre, (seg, fg) in zip(pres, self._cases(pres, spacing_r)):
            seg_3mm = remove_3mm_sparks(seg, spacing_r)
            mask = brain_extract(pre, spacing_r)
            seg_fov = ((seg_3mm * mask) > 0.5).float()
            out.append((pre, seg, seg_3mm, seg_fov, fg))
        return out

    @torch.inference_mode()
    def predict_case_full(self, data, spacing, apply_n4: bool = False):
        """The whole per-case pipeline — optional N4, resample/z-score,
        sweep, resample back, threshold, 3 mm spark removal, brain-FOV
        masking. Returns (pre, seg_raw, seg_3mm, seg_fov, fg) in the
        original grid: f32, uint8, f32, f32, f32."""
        return self._full([self._tensor(data)], spacing, apply_n4)[0]

    @torch.inference_mode()
    def predict_case_full_batch(self, datas, spacing, apply_n4: bool = False):
        """predict_case_full for a burst of same-geometry volumes [B,D,H,W]
        (the serving burst path): N4 and preprocessing per case, the U-Net
        sweep over the stacked batch, then resampling, threshold, spark
        removal and the brain mask per case. Returns the same 5-tuple with
        a leading batch axis."""
        raws = self._tensor(datas)
        if raws.dim() != 4:
            raise ValueError("expect [B,D,H,W] volumes (got shape %s)" % (tuple(raws.shape),))
        return tuple(torch.stack(o) for o in zip(*self._full(list(raws), spacing, apply_n4)))
