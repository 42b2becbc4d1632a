"""Synthetic FLAIR cohorts with known lesions (the port of
``deepwmh_tpu.eval.phantom``): the stand-in for real cohorts that the
train -> predict accuracy harness (``eval/e2e.py``) and the registration
quality measurement (``registration/quality.py``) score against.

- One base head with the reference's 4-class tissue topology (0
  background, 1 cerebrum, 2 cerebellum + brainstem, 3 cortex) and dark CSF
  ventricles;
- per-subject anatomy: a smooth random diffeomorphism (a low-resolution
  Gaussian velocity integrated by scaling and squaring) composed with a
  small random affine;
- a per-subject multiplicative bias field, gain jitter and noise;
- graded hyperintense WM lesions with soft edges and an exact binary ground
  truth.

The ``np.random.RandomState`` draws are the JAX package's, in the same
order, and the warps run on the port's ops with JAX's arithmetic (order-0
sampling rounds halves away from zero), so a (shape, seed) gives the same
subject in both packages. The functions take ``device`` like every entry
point: CUDA unless the CPU is asked for.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepwmh_tpu_torch.device import resolve_device

# FLAIR-like mean intensities per structure: CSF dark (FLAIR nulls it),
# cortex brighter than WM, lesions hyperintense above cortex so the
# one-sided '+' NLL prior applies
INTENSITY = {
    "wm": 300.0,
    "cortex": 360.0,
    "cerebellum": 330.0,
    "csf": 110.0,
    "lesion_amp": 170.0,  # additive at lesion core
}


def _norm_grid(shape):
    return np.meshgrid(
        *[np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape],
        indexing="ij",
    )


def base_tissue(shape):
    """The base head: (tissue uint8 [D,H,W] in {0,1,2,3}, csf mask bool).
    Axis 0 inferior -> superior, 1 posterior -> anterior, 2 left -> right;
    the ventricles lie inside class 1 but are dark on FLAIR."""
    g = _norm_grid(shape)
    # brain ellipsoid, slightly prolate along the AP axis
    r = np.sqrt((g[0] / 0.78) ** 2 + (g[1] / 0.88) ** 2 + (g[2] / 0.74) ** 2)
    brain = r < 1.0
    cortex = (r >= 0.82) & brain

    # cerebellum + brainstem: inferior-posterior ellipsoid
    rc = np.sqrt(
        ((g[0] + 0.52) / 0.34) ** 2
        + ((g[1] + 0.42) / 0.40) ** 2
        + (g[2] / 0.46) ** 2
    )
    cereb = (rc < 1.0) & brain

    # lateral ventricles: two small CSF ellipsoids inside the cerebrum
    csf = np.zeros(shape, bool)
    for sx in (-0.14, 0.14):
        rv = np.sqrt(
            ((g[0] - 0.08) / 0.30) ** 2
            + ((g[1] - 0.05) / 0.22) ** 2
            + ((g[2] - sx) / 0.09) ** 2
        )
        csf |= rv < 1.0
    csf &= brain & ~cortex & ~cereb

    tissue = np.zeros(shape, np.uint8)
    tissue[brain] = 1
    tissue[cortex] = 3
    tissue[cereb] = 2
    return tissue, csf


def _smooth_noise(shape, rng, dev, down=6, sigma=1.2):
    """Smooth random scalar field ~N(0,1) at full resolution: low-res
    Gaussian noise, Gaussian-smoothed, linearly upsampled, renormalised."""
    from deepwmh_tpu_torch.ops.grid import linear_resize_axis
    from deepwmh_tpu_torch.registration.svf import _smooth3

    lo = [max(s // down, 4) for s in shape]
    f = torch.from_numpy(rng.randn(*lo).astype(np.float32)).to(dev)
    x = _smooth3(f[None].repeat(3, 1, 1, 1), sigma)[0]
    for ax in range(3):
        x = linear_resize_axis(x, ax, int(shape[ax]))
    x = x.cpu().numpy()
    return (x - x.mean()) / max(x.std(), 1e-6)


def random_diffeo(shape, rng, max_disp_vox=5.0, device=None):
    """Smooth random diffeomorphic displacement [3,D,H,W] (voxel units,
    numpy f32): a random low-res velocity integrated by scaling and
    squaring, generated independently of any image."""
    from deepwmh_tpu_torch.registration.svf import scaling_and_squaring

    dev = resolve_device(device)
    v = np.stack([_smooth_noise(shape, rng, dev) for _ in range(3)])
    mag = np.sqrt((v**2).sum(0)).max()
    v = v * (max_disp_vox / max(mag, 1e-6))
    return scaling_and_squaring(torch.from_numpy(v.astype(np.float32)).to(dev), n=4).cpu().numpy()


def random_affine(rng, shape, max_rot_deg=5.0, max_scale=0.05, max_shift_vox=3.0):
    """Small random rigid + scale matrix [3,4] in voxel coordinates about
    the volume centre (input = A(o - c) + c + t)."""
    from deepwmh_tpu_torch.ops.warp import rotation_matrix

    ang = np.deg2rad(rng.uniform(-max_rot_deg, max_rot_deg, 3)).astype(np.float32)
    R = rotation_matrix(torch.from_numpy(ang)).numpy()
    S = np.diag(1.0 + rng.uniform(-max_scale, max_scale, 3)).astype(np.float32)
    A = (R @ S).astype(np.float32)
    t = rng.uniform(-max_shift_vox, max_shift_vox, 3).astype(np.float32)
    c = (np.asarray(shape, np.float32) - 1.0) / 2.0
    t_centered = c - A @ c + t
    return np.concatenate([A, t_centered[:, None]], axis=1).astype(np.float32)


def _erode(mask, r):
    """r-step 6-neighbourhood erosion via np.roll (small volumes only)."""
    out = mask.copy()
    for _ in range(r):
        nxt = out.copy()
        for ax in range(3):
            nxt &= np.roll(out, 1, ax) & np.roll(out, -1, ax)
        out = nxt
    return out


def make_lesions(tissue, csf, rng, n_lesions=(2, 5), radius_vox=(2.0, 4.5)):
    """Graded hyperintense WM lesions: (additive intensity field, binary
    GT). Centres lie in eroded cerebral WM; each lesion is a sigmoid radial
    profile whose half-maximum surface is the ground-truth boundary."""
    shape = tissue.shape
    wm = (tissue == 1) & ~csf
    n = rng.randint(n_lesions[0], n_lesions[1] + 1)
    add = np.zeros(shape, np.float32)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    placed = 0
    seed_region = _erode(wm, 5)
    idx = np.argwhere(seed_region)
    if len(idx) == 0:
        seed_region = _erode(wm, 2)
        idx = np.argwhere(seed_region)
    while placed < n and len(idx) > 0:
        c = idx[rng.randint(len(idx))]
        rad = rng.uniform(*radius_vox)
        d = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        # value 0.5 exactly at d = rad, a < 1-voxel soft edge: the first
        # voxel outside stays below the texture noise
        prof = 1.0 / (1.0 + np.exp(-(rad - d) / 0.4))
        add = np.maximum(add, prof.astype(np.float32))
        placed += 1
    gt = (add > 0.5) & wm
    return add * INTENSITY["lesion_amp"] * wm, gt.astype(np.uint8)


def make_subject(shape, seed, lesion=False, max_disp_vox=5.0, bias_amp=0.15,
                 noise_sigma=8.0, device=None):
    """One synthetic subject: {"flair" f32, "label1" uint8 brain mask,
    "label2" uint8 tissue class, "lesion_gt" uint8 (zeros without
    ``lesion``)}, numpy [D,H,W]. The labels are warped (nearest) first and
    the image is synthesised from them, so edges are crisp and the GT
    exact."""
    from deepwmh_tpu_torch.ops.warp import compose_affine_then_disp, sample_volume

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    tissue, csf = base_tissue(shape)

    disp = random_diffeo(shape, rng, max_disp_vox=max_disp_vox, device=dev)
    mat = random_affine(rng, shape)
    # pull-back coordinates [3,D,H,W]
    coords = compose_affine_then_disp(torch.from_numpy(mat).to(dev),
                                      torch.from_numpy(disp).to(dev))

    def warp(a):
        return sample_volume(torch.from_numpy(a.astype(np.float32)).to(dev), coords,
                             order=0).cpu().numpy()

    t_w = warp(tissue).astype(np.uint8)
    csf_w = warp(csf) > 0.5

    flair = np.zeros(shape, np.float32)
    flair[(t_w == 1) & ~csf_w] = INTENSITY["wm"]
    flair[t_w == 2] = INTENSITY["cerebellum"]
    flair[t_w == 3] = INTENSITY["cortex"]
    flair[csf_w] = INTENSITY["csf"]

    # smooth intra-tissue texture + per-subject bias field + gain + noise
    flair += 15.0 * _smooth_noise(shape, rng, dev) * (t_w > 0)

    lesion_gt = np.zeros(shape, np.uint8)
    if lesion:
        add, lesion_gt = make_lesions(t_w, csf_w, rng)
        flair += add

    bias = np.exp(bias_amp * _smooth_noise(shape, rng, dev, down=10, sigma=2.0))
    gain = rng.uniform(0.9, 1.1)
    flair = flair * bias.astype(np.float32) * gain
    flair += noise_sigma * rng.randn(*shape).astype(np.float32)
    flair = np.maximum(flair, 0.0)

    return {
        "flair": flair.astype(np.float32),
        "label1": (t_w > 0).astype(np.uint8),
        "label2": t_w,
        "lesion_gt": lesion_gt,
    }


def cohort_geometry(shape, spacing, shapes, spacings, index):
    """(shape, spacing) of cohort position ``index``: ``shapes`` /
    ``spacings`` are optional per-subject cycles (a heterogeneous cohort);
    None gives the homogeneous (shape, spacing)."""
    sh = tuple(shapes[index % len(shapes)]) if shapes else tuple(shape)
    sp = tuple(spacings[index % len(spacings)]) if spacings else tuple(spacing)
    return sh, sp


def phantom_header(shape, spacing):
    from deepwmh_tpu_torch.core import nifti

    hdr = nifti.NiftiHeader()
    hdr.set_shape(shape)
    hdr.set_zooms(spacing)
    return hdr


def write_cohort(out_dir, shape=(64, 80, 64), spacing=(2.0, 2.0, 2.0),
                 n_ref=3, n_train=3, seed=0, max_disp_vox=5.0,
                 shapes=None, spacings=None, device=None):
    """Write a train-ready cohort: healthy references REFnn (seeds seed +
    i, with label1 / label2) and patients SUBnn (seeds seed + 1000 + i,
    with their lesion GT). Returns (reference_csv, training_csv, {case:
    lesion_gt_path}), CSVs in the training CLI's contract."""
    from deepwmh_tpu_torch.core import nifti
    from deepwmh_tpu_torch.core.manifests import write_csv_simple

    os.makedirs(out_dir, exist_ok=True)

    ref_rows = {"case": [], "desc": [], "flair": [], "label1": [], "label2": []}
    for i in range(n_ref):
        sh, sp = cohort_geometry(shape, spacing, shapes, spacings, i)
        sub = make_subject(sh, seed=seed + i, lesion=False, max_disp_vox=max_disp_vox,
                           device=device)
        case = "REF%02d" % i
        paths = {
            k: os.path.join(out_dir, "%s_%s.nii.gz" % (case, k))
            for k in ("flair", "label1", "label2")
        }
        for k, p in paths.items():
            nifti.save_nifti(sub[k].astype(np.float32), phantom_header(sh, sp), p)
        ref_rows["case"].append(case)
        ref_rows["desc"].append("healthy")
        for k in ("flair", "label1", "label2"):
            ref_rows[k].append(paths[k])

    train_rows = {"case": [], "desc": [], "flair": []}
    gt_paths = {}
    for i in range(n_train):
        sh, sp = cohort_geometry(shape, spacing, shapes, spacings, n_ref + i)
        sub = make_subject(sh, seed=seed + 1000 + i, lesion=True, max_disp_vox=max_disp_vox,
                           device=device)
        case = "SUB%02d" % i
        fp = os.path.join(out_dir, "%s_flair.nii.gz" % case)
        gp = os.path.join(out_dir, "%s_lesion_gt.nii.gz" % case)
        nifti.save_nifti(sub["flair"], phantom_header(sh, sp), fp)
        nifti.save_nifti(sub["lesion_gt"].astype(np.float32), phantom_header(sh, sp), gp)
        train_rows["case"].append(case)
        train_rows["desc"].append("patient")
        train_rows["flair"].append(fp)
        gt_paths[case] = gp

    ref_csv = os.path.join(out_dir, "reference.csv")
    train_csv = os.path.join(out_dir, "training.csv")
    write_csv_simple(ref_csv, ref_rows)
    write_csv_simple(train_csv, train_rows)
    return ref_csv, train_csv, gt_paths
