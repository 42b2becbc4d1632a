"""GIF previews of a segmentation (the port's copy of the parts of
``deepwmh_tpu.eval.preview`` the predict path uses): axial slices animated,
the image side by side with a red lesion overlay, empty slices trimmed.
PIL is imported lazily; previews are best-effort."""

from __future__ import annotations

import os

import numpy as np

_AXIS = {"sagittal": 0, "coronal": 1, "axial": 2}


def _to_uint8(img2d, lo, hi):
    x = np.clip((img2d - lo) / max(hi - lo, 1e-8), 0, 1)
    return (x * 255).astype(np.uint8)


def nii_slice_range(data, axis="axial", value=None, percentage=0.999):
    """First/last slice index with content: a slice is 'empty' when at
    least `percentage` of its voxels are <= value."""
    ax = _AXIS[axis] if isinstance(axis, str) else int(axis)
    if value is None:
        value = float(np.min(data)) + 0.001
    other = tuple(a for a in range(3) if a != ax)
    frac_empty = (data <= value).mean(axis=other)
    keep = np.where(frac_empty < percentage)[0]
    if len(keep) == 0:
        return 0, data.shape[ax] - 1
    return int(keep[0]), int(keep[-1])


def _slice2d(data, ax, idx):
    sl = [slice(None)] * 3
    sl[ax] = idx
    return np.asarray(data[tuple(sl)])


def nii_as_gif(image, out_gif, axis="axial", lesion_mask=None, side_by_side=True,
               slice_range=None, fps=8, max_size=320):
    """Animated GIF of the volume with an optional red lesion overlay."""
    from PIL import Image

    image = np.asarray(image, np.float32)
    ax = _AXIS[axis] if isinstance(axis, str) else int(axis)
    lo, hi = np.percentile(image, 1), np.percentile(image, 99)
    s0, s1 = slice_range if slice_range else (0, image.shape[ax] - 1)
    frames = []
    for idx in range(s0, s1 + 1):
        g = _to_uint8(_slice2d(image, ax, idx), lo, hi)
        rgb = np.stack([g, g, g], axis=-1)
        if lesion_mask is not None:
            m = _slice2d(lesion_mask, ax, idx) > 0.5
            overlay = rgb.copy()
            overlay[m] = [255, 48, 48]
            rgb = np.concatenate([rgb, overlay], axis=1) if side_by_side else overlay
        img = Image.fromarray(np.rot90(rgb))
        limit = max_size * (2 if side_by_side else 1)
        if max(img.size) > limit:
            scale = limit / max(img.size)
            img = img.resize(
                (int(img.size[0] * scale), int(img.size[1] * scale)), Image.NEAREST)
        frames.append(img)
    os.makedirs(os.path.dirname(os.path.abspath(out_gif)), exist_ok=True)
    frames[0].save(out_gif, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def try_load_gif(path) -> bool:
    try:
        from PIL import Image

        with Image.open(path) as im:
            im.verify()
        return True
    except Exception:
        return False
