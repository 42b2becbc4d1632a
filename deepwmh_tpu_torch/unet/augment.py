"""Training augmentations on the device (the port of
``deepwmh_tpu.unet.augment``): rotation + scaling about the patch centre,
Gaussian noise, brightness, contrast, gamma and mirroring, each with its
nnU-Net default probability, and the reference's mixed-cohort percentile
noise.

Each sample's augmentation is split in two. ``draw_augment`` takes its
random values from a ``torch.Generator``: the 13 draws of the JAX package's
key split, in its order. ``apply_augment`` is deterministic in those
values, so a test can hand it the JAX package's draws. A branch whose coin
says no is skipped (the JAX package computes every intensity branch and
selects, which gives the same values); the spatial warp, the costly one, is
skipped there too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deepwmh_tpu_torch.ops.warp import affine_warp, rotation_matrix


@dataclass(frozen=True)
class AugmentConfig:
    p_rotscale: float = 0.2
    rot_max_rad: float = 0.5236  # 30 degrees
    scale_range: tuple = (0.7, 1.4)
    p_noise: float = 0.1
    noise_std_max: float = 0.1
    p_brightness: float = 0.15
    brightness_range: tuple = (0.7, 1.3)
    p_contrast: float = 0.15
    contrast_range: tuple = (0.65, 1.5)
    p_gamma: float = 0.3
    gamma_range: tuple = (0.7, 1.5)
    p_mirror: float = 0.5  # per axis


@dataclass
class AugmentDraws:
    """The random values of one sample's augmentation."""

    angles: tuple  # 3 rotation angles, radians
    scale: float
    spatial: bool
    noise_std: float
    noise: torch.Tensor  # standard normal field of the image's shape
    noise_on: bool
    brightness: float
    brightness_on: bool
    contrast: float
    contrast_on: bool
    gamma: float
    gamma_on: bool
    mirror: tuple  # 3 flags, one per axis


def draw_augment(gen: torch.Generator, shape, cfg: AugmentConfig = AugmentConfig()):
    """One sample's draws from ``gen`` (on the generator's device), in the
    JAX package's order: angles, scale, spatial coin, noise std, noise
    field, noise coin, brightness and its coin, contrast and its coin,
    gamma and its coin, three mirror coins. The scalars reach the host in
    one transfer."""
    dev = gen.device
    head = torch.rand(6, generator=gen, device=dev)
    noise = torch.randn(tuple(shape), generator=gen, device=dev)
    tail = torch.rand(10, generator=gen, device=dev)
    u = torch.cat([head, tail]).tolist()

    def between(v, lo_hi):
        return lo_hi[0] + v * (lo_hi[1] - lo_hi[0])

    rot = (-cfg.rot_max_rad, cfg.rot_max_rad)
    return AugmentDraws(
        angles=tuple(between(v, rot) for v in u[0:3]),
        scale=between(u[3], cfg.scale_range),
        spatial=u[4] < cfg.p_rotscale,
        noise_std=u[5] * cfg.noise_std_max,
        noise=noise,
        noise_on=u[6] < cfg.p_noise,
        brightness=between(u[7], cfg.brightness_range),
        brightness_on=u[8] < cfg.p_brightness,
        contrast=between(u[9], cfg.contrast_range),
        contrast_on=u[10] < cfg.p_contrast,
        gamma=between(u[11], cfg.gamma_range),
        gamma_on=u[12] < cfg.p_gamma,
        mirror=tuple(v < cfg.p_mirror for v in u[13:16]),
    )


def apply_augment(image, label, d: AugmentDraws):
    """image [D,H,W] f32 (z-scored), label [D,H,W] integer -> the augmented
    pair (f32, int64), deterministic in ``d``."""
    label = label.float()
    if d.spatial:
        # pull-back matrix about the patch centre: output -> input = R^T / scale
        A = rotation_matrix(d.angles).T / torch.tensor(d.scale, dtype=torch.float32)
        mat = torch.cat([A, torch.zeros(3, 1)], dim=1)
        center = [(s - 1) / 2.0 for s in image.shape]
        image = affine_warp(image, mat, order=1, center=center)
        label = affine_warp(label, mat, order=0, center=center)
    if d.noise_on:
        image = image + d.noise * d.noise_std
    if d.brightness_on:
        image = image * d.brightness
    if d.contrast_on:
        # nnU-Net's preserve_range: clamp to the range before the transform
        mn = image.mean()
        image = torch.minimum(torch.maximum((image - mn) * d.contrast + mn, image.min()),
                              image.max())
    if d.gamma_on:
        # on the min-max normalised image
        lo, hi = image.min(), image.max()
        span = torch.clamp(hi - lo, min=1e-7)
        image = torch.pow((image - lo) / span, d.gamma) * span + lo
    axes = tuple(a for a, f in enumerate(d.mirror) if f)
    if axes:
        image, label = image.flip(axes), label.flip(axes)
    return image, label.long()


def augment_sample(gen, image, label, cfg: AugmentConfig = AugmentConfig()):
    return apply_augment(image, label, draw_augment(gen, image.shape, cfg))


def augment_samples(gen, images, labels, cfg: AugmentConfig = AugmentConfig()):
    """Per-sample augmentation of [N,D,H,W] images and labels, samples in
    order from one generator."""
    outs = [augment_sample(gen, images[i], labels[i], cfg) for i in range(images.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def percentile_noise(gen: torch.Generator, image, scale: float = 0.1):
    """The reference's mixed-cohort augmentation: additive Gaussian noise of
    std scale * (q95 - q5), percentiles interpolated linearly as
    ``jnp.percentile`` does."""
    q5, q95 = torch.quantile(image.float().reshape(-1),
                             torch.tensor([0.05, 0.95], device=image.device))
    noise = torch.randn(tuple(image.shape), generator=gen, device=gen.device)
    return image + noise.to(image.device) * (scale * (q95 - q5))
