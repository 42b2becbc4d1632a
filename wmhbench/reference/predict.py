"""One predict case in plain float32 PyTorch: the benchmark's reference for
the predict cells (the port's ``SlidingWindowPredictor.predict_case_full``
on the whole-volume route, as ``predict_one_case`` drives it).

N4 -> resample to the plan's spacing and z-score -> pad to the network's
stride -> the mean softmax over the 8 axis flips -> crop, resample the
foreground probability back, threshold at 0.5 -> 3 mm spark removal ->
brain mask -> the FOV mask. Returns the four artifacts the program writes:
the N4 output, the raw mask, the 3 mm mask and the FOV mask.

``precision="control"`` is the control: the network's convolutions in
float8 (``unet.fp8_round``) and the N4 output rounded to bfloat16, the
precisions one step below what the configuration states.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import torch

from wmhbench.arith.unet import fullvol_shape
from wmhbench.reference.brain import brain_extract
from wmhbench.reference.components import remove_3mm_sparks
from wmhbench.reference.n4 import n4_bias_correction
from wmhbench.reference.preprocess import pad_to, preprocess_case, resample_to_shape
from wmhbench.reference.unet import UNet3D

ALL_FLIPS = tuple(itertools.product((False, True), repeat=3))


def make_model(plan: dict, state_dict: dict, device, precision: str) -> UNet3D:
    model = UNet3D(plan, "fp8" if precision == "control" else "f32")
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


@torch.no_grad()
def fullvol_tta(model, vol):
    """Mean softmax [D, H, W, C] of one padded volume over the 8 flips."""
    acc = None
    for flip in ALL_FLIPS:
        axes = tuple(a for a, f in enumerate(flip) if f)
        v = vol.flip(axes) if axes else vol
        p = torch.softmax(model(v[None, None]).float(), dim=1)[0].permute(1, 2, 3, 0)
        p = p.flip(axes) if axes else p
        acc = p if acc is None else acc + p
    return acc / len(ALL_FLIPS)


@torch.no_grad()
def predict_case(model, plan: dict, raw, spacing, precision: str = "f32") -> dict:
    """raw: f32 [D, H, W] on the model's device; spacing in mm."""
    spacing_r = tuple(round(float(s), 4) for s in spacing)
    pre = n4_bias_correction(raw.float())
    if precision == "control":
        pre = pre.to(torch.bfloat16).float()
    vol = preprocess_case(pre, spacing_r,
                          SimpleNamespace(target_spacing=plan["target_spacing"]))
    res_shape = tuple(vol.shape)
    probs = fullvol_tta(model, pad_to(vol, fullvol_shape(res_shape, plan)))
    fg = probs[: res_shape[0], : res_shape[1], : res_shape[2], 1]
    fg = resample_to_shape(fg, tuple(raw.shape), order=1)
    seg = (fg > 0.5).to(torch.uint8)
    seg_3mm = remove_3mm_sparks(seg, spacing_r)
    mask = brain_extract(pre, spacing_r)
    seg_fov = ((seg_3mm * mask) > 0.5).float()
    return {"pre": pre, "raw": seg.float(), "post_3mm": seg_3mm, "post_fov": seg_fov,
            "fg": fg}
