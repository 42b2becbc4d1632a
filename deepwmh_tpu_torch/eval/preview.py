"""Qualitative previews (the port's copy of ``deepwmh_tpu.eval.preview``):
animated GIFs of a segmentation (axial slices, the image side by side with
a red lesion overlay, empty slices trimmed), single annotated slices
through a named colormap, colorbars and lightbox montages. Vectorised
numpy; PIL (and scipy for the aspect resampling) are imported at the call,
so a host without them still imports this module."""

from __future__ import annotations

import math
import os

import numpy as np

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.eval.colormaps import apply_colormap, list_colormaps

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


# 3x5 bitmap digit font for burnt-in slice numbering (the reference stamps
# slice numbers with a bitmap glyph bank, nii_preview.py:20-31,242-370;
# these glyphs are our own, rendered vectorized instead of per-pixel)
_DIGITS = {
    "0": ("###", "# #", "# #", "# #", "###"),
    "1": (" # ", "## ", " # ", " # ", "###"),
    "2": ("###", "  #", "###", "#  ", "###"),
    "3": ("###", "  #", " ##", "  #", "###"),
    "4": ("# #", "# #", "###", "  #", "  #"),
    "5": ("###", "#  ", "###", "  #", "###"),
    "6": ("###", "#  ", "###", "# #", "###"),
    "7": ("###", "  #", " # ", " # ", " # "),
    "8": ("###", "# #", "###", "# #", "###"),
    "9": ("###", "# #", "###", "  #", "###"),
}


def _stamp_number(rgb, number: int, zoom: int = 1, margin: int = 1):
    """Burn `number` into the top-left corner of an [H,W,3] uint8 image."""
    zoom = max(int(zoom), 1)
    x = margin
    for ch in str(int(number)):
        glyph = np.array(
            [[c == "#" for c in row] for row in _DIGITS[ch]], bool
        )
        g = np.kron(glyph, np.ones((zoom, zoom), bool))
        h, w = g.shape
        if margin + h > rgb.shape[0] or x + w > rgb.shape[1]:
            break
        region = rgb[margin : margin + h, x : x + w]
        region[g] = 255
        region[~g] = region[~g] // 2  # darken background for contrast
        x += w + zoom
    return rgb


def save_slice_png(
    slice2d,
    out_png,
    colormap="grayscale",
    lo=None,
    hi=None,
    slice_number=None,
    font_zoom=1,
):
    """Render ONE 2-D slice to an image file through a named colormap, with
    an optional burnt-in slice number (reference
    nii_preview.py:242-291 nii_save_slice_as_image)."""
    from PIL import Image

    s = np.asarray(slice2d, np.float32)
    lo = float(np.min(s)) if lo is None else float(lo)
    hi = float(np.max(s)) if hi is None else float(hi)
    rgb = apply_colormap((s - lo) / max(hi - lo, 1e-8), colormap)
    rgb = np.ascontiguousarray(np.rot90(rgb))
    if slice_number is not None:
        _stamp_number(rgb, slice_number, zoom=font_zoom)
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    Image.fromarray(rgb).save(out_png)


def view_slice(
    image,
    out_png,
    axis="axial",
    slice_num=None,
    reverse_slice_order=False,
    show_slice_number=False,
    hflip=False,
    vflip=False,
    intensity_range=None,
    colormap="grayscale",
    crop=None,
    spacing=None,
    anisotropic_resize=True,
    global_zoom=1,
):
    """Save a single annotated slice of a volume as a PNG (reference
    nii_view_slice, nii_preview.py:293-370): axis/slice selection with
    optional order reversal, h/v flips, [x1,y1,x2,y2] crop, aspect-correct
    resampling from the voxel spacing, integer zoom, intensity windowing
    ([lo,hi], either side None -> data min/max) and burnt-in slice number."""
    from scipy.ndimage import zoom as ndzoom

    data = np.asarray(image, np.float32)
    ax = _AXIS[axis] if isinstance(axis, str) else int(axis)
    if slice_num is None:
        raise ValueError("slice_num is required")
    s = int(slice_num)
    if reverse_slice_order:
        s = data.shape[ax] - s - 1
    sl = _slice2d(data, ax, s)
    if hflip:
        sl = sl[:, ::-1]
    if vflip:
        sl = sl[::-1, :]
    if crop:
        x1, y1, x2, y2 = crop
        sl = sl[x1:x2, y1:y2]
    if anisotropic_resize and spacing is not None:
        res = [spacing[a] for a in range(3) if a != ax]
        aspect = res[0] / res[1]
        if abs(aspect - 1.0) > 1e-6:
            sl = ndzoom(sl, [aspect, 1.0], order=3)
    if int(global_zoom) > 1:
        sl = np.kron(sl, np.ones((int(global_zoom),) * 2, sl.dtype))
    lo = hi = None
    if intensity_range is not None:
        lo, hi = intensity_range
    lo = float(np.min(data)) if lo is None else float(lo)
    hi = float(np.max(data)) if hi is None else float(hi)
    save_slice_png(
        sl, out_png, colormap=colormap, lo=lo, hi=hi,
        slice_number=int(slice_num) if show_slice_number else None,
        font_zoom=global_zoom,
    )


class SimpleNiftiPreview:
    """Single-slice NIfTI preview with pinned windowing + colormap
    (reference SimpleNiftiPreview, nii_preview.py:603-636): construct with
    the display options, then plot() any slice of any file, optionally
    rendering the matching colorbar swatch."""

    def __init__(self, min_intensity="auto", max_intensity="auto",
                 colormap="grayscale"):
        if colormap not in list_colormaps():
            raise ValueError(
                "invalid colormap %r, must be one of: %s"
                % (colormap, " ".join(list_colormaps())))
        for v in (min_intensity, max_intensity):
            if v != "auto" and not isinstance(v, (int, float)):
                raise ValueError("intensity bounds must be 'auto' or numeric")
        self.min_intensity = min_intensity
        self.max_intensity = max_intensity
        self.colormap = colormap

    def plot(self, nifti_file, axis, slice_num, output_image,
             output_colormap=None, vflip=False, hflip=False):
        if output_colormap is not None:
            draw_colorbar(output_colormap, colormap=self.colormap)
        data, hdr = nifti.load_nifti(nifti_file)
        lo = None if self.min_intensity == "auto" else float(self.min_intensity)
        hi = None if self.max_intensity == "auto" else float(self.max_intensity)
        view_slice(
            data, output_image, axis=axis, slice_num=slice_num,
            intensity_range=[lo, hi], colormap=self.colormap,
            vflip=vflip, hflip=hflip, spacing=hdr.zooms,
        )
        return output_image


def draw_colorbar(out_png, colormap="grayscale", size=(256, 48)):
    """Render a horizontal colorbar swatch for a named colormap (reference
    nii_draw_colorbar, nii_preview.py:372-380: a [length,width] gradient
    along the first axis, transposed so the gradient runs left->right)."""
    from PIL import Image

    length, width = int(size[0]), int(size[1])
    grad = np.arange(length, dtype=np.float64) / length
    rgb = apply_colormap(grad, colormap)  # [length, 3]
    bar = np.broadcast_to(rgb[None, :, :], (width, length, 3))
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    Image.fromarray(np.ascontiguousarray(bar)).save(out_png)


def try_load_gif(path) -> bool:
    try:
        from PIL import Image

        with Image.open(path) as im:
            im.verify()
        return True
    except Exception:
        return False


def lightbox(image, out_png, axis="axial", ncols=8, lesion_mask=None, slice_step=1):
    """Montage PNG of all (or every slice_step-th) slice
    (reference nii_preview.py:101-240)."""
    from PIL import Image

    image = np.asarray(image, np.float32)
    ax = _AXIS[axis] if isinstance(axis, str) else int(axis)
    lo, hi = np.percentile(image, 1), np.percentile(image, 99)
    idxs = list(range(0, image.shape[ax], slice_step))
    tiles = []
    for idx in idxs:
        g = _to_uint8(_slice2d(image, ax, idx), lo, hi)
        rgb = np.stack([g, g, g], axis=-1)
        if lesion_mask is not None:
            m = _slice2d(lesion_mask, ax, idx) > 0.5
            rgb[m] = [255, 48, 48]
        tiles.append(np.rot90(rgb))
    th, tw = tiles[0].shape[:2]
    nrows = math.ceil(len(tiles) / ncols)
    canvas = np.zeros((nrows * th, ncols * tw, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, ncols)
        canvas[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = t
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    Image.fromarray(canvas).save(out_png)
