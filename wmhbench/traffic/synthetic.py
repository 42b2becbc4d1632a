"""The benchmark's input generators: frozen copies of the port's
``chip_smoke.py`` ``synthetic_flair`` and ``synthetic_cohort`` (numpy, from
a seed), and the train cells' cases made from them."""

from __future__ import annotations

import numpy as np


def synthetic_flair(shape, seed):
    """A head-shaped FLAIR-like volume: textured ellipsoid on a dim
    background."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a**2 for a in g))
    head = (r < 0.85).astype(np.float32)
    tex = rng.rand(*shape).astype(np.float32)
    return head * (400 + 150 * tex) + 30 * rng.rand(*shape).astype(np.float32)


LESION_CENTERS = ((0.3, 0.2, 0.3), (-0.35, -0.1, 0.2), (0.0, 0.4, -0.1),
                  (0.15, -0.2, -0.6))  # the last lies in the class-2 region
LESION_RADIUS = 0.1


def synthetic_cohort(shape, K, seed):
    """A registered stage-1 cohort, in normalised [-1, 1] coordinates per
    axis: an ellipsoidal brain with a smooth gradient and dark ventricles;
    K references (the brain plus noise) with label1 brain masks and label2
    tissue maps (0 outside, 1 cerebrum, 2 an inferior region, 3 the
    ventricles), each boundary moved a little per reference; a target with
    four bright spherical lesions. Returns (target [D,H,W], refs, label1s,
    label2s [K,D,H,W], lesions), f32."""
    rng = np.random.default_rng(seed)
    a, b, c = (np.linspace(-1, 1, s, dtype=np.float32).reshape(
        [-1 if i == ax else 1 for i in range(3)]) for ax, s in enumerate(shape))
    r = np.sqrt((a / 0.8) ** 2 + (b / 0.85) ** 2 + (c / 0.8) ** 2)
    vent = (a / 0.25) ** 2 + (b / 0.35) ** 2 + ((c - 0.1) / 0.25) ** 2
    brain = r < 1.0
    base = np.where(vent < 1.0, 90.0, 200.0 + 40.0 * np.cos(3.0 * c) + 20.0 * a)
    base = (base * brain).astype(np.float32)

    def noisy():
        return base + 8.0 * rng.standard_normal(shape, dtype=np.float32) * brain

    refs = np.empty((K,) + tuple(shape), np.float32)
    l1 = np.empty_like(refs)
    l2 = np.empty_like(refs)
    for k in range(K):
        refs[k] = noisy()
        brain_k = r < 1.0 + 0.02 * rng.standard_normal()
        l1[k] = brain_k
        cb_k = brain_k & (c < -0.45 + 0.03 * rng.standard_normal()) & (np.abs(a) < 0.6)
        l2[k] = np.where(brain_k & (vent < 1.0 + 0.05 * rng.standard_normal()), 3.0,
                         np.where(cb_k, 2.0, brain_k.astype(np.float32)))
    lesions = np.zeros(shape, bool)
    for ca, cb, cc in LESION_CENTERS:
        lesions |= (a - ca) ** 2 + (b - cb) ** 2 + (c - cc) ** 2 < LESION_RADIUS ** 2
    lesions = (lesions & brain).astype(np.float32)
    return noisy() + 150.0 * lesions, refs, l1, l2, lesions


def train_case(shape, seed, label_noise: float):
    """A preprocessed training case: a K = 0 cohort's target z-scored over
    the volume, and its lesion mask with a share ``label_noise`` of the
    brain's voxels flipped, as stage I's pseudo-labels are noisy."""
    target, _refs, _l1, _l2, lesions = synthetic_cohort(shape, 0, seed)
    image = (target - target.mean()) / max(float(target.std()), 1e-8)
    rng = np.random.default_rng(seed + 1)
    flip = (rng.random(shape, dtype=np.float32) < label_noise) & (target > 0)
    label = np.where(flip, 1.0 - lesions, lesions)
    return image.astype(np.float32), label.astype(np.uint8)
