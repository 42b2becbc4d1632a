"""Convert the reference's released PyTorch nnU-Net checkpoints (the port
of ``deepwmh_tpu.unet.torch_convert``).

The reference ships trained models as pickled PyTorch checkpoints of its
nnU-Net fork's Generic_UNet, installed as
``nnUNet/3d_fullres/<task>/nnUNetTrainerV2__nnUNetPlansv2.1/all/
model_best.model`` beside ``plans.pkl``. Both networks are the same
topology (conv -> instance norm -> leaky ReLU blocks, strided-conv
downsampling, transpose-conv upsampling with skip concatenation, one
segmentation head a level), so in PyTorch the conversion is a relayout of
one ``state_dict`` into another, every tensor copied unchanged:

- conv weights keep torch's ``[out, in, kd, kh, kw]``;
- transpose convs keep torch's ``[in, out, kd, kh, kw]``: the port's
  ``UNet3D`` runs ``F.conv_transpose3d`` as Generic_UNet does, so no
  spatial flip (the JAX package flips because ``lax.conv_transpose``
  correlates);
- ``InstanceNorm3d`` affine weight / bias -> the block's
  ``norm_weight`` / ``norm_bias``;
- the fork's bias-free segmentation heads get a zero bias;
- strided convs pad symmetrically (k // 2) in torch, so converted plans set
  ``pad_style="torch"`` (``unet/plan.py``).

The package written is the shared format (``plan.json``, ``model_best``
msgpack weights, the manifest), which both packages' ``load_released_model``
read.

SECURITY NOTE: torch checkpoints and plans.pkl are pickles (``torch.load``
runs with ``weights_only=False``): only convert files you trust, exactly as
the reference's own installer requires (it loads and rewrites the same
pickles).
"""

from __future__ import annotations

import os
import pickle
import warnings

import numpy as np
import torch

from deepwmh_tpu_torch.core.artifacts import atomic_write_json, mkdir
from deepwmh_tpu_torch.pkginfo import __version__
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet import release
from deepwmh_tpu_torch.unet.model import UNet3D
from deepwmh_tpu_torch.unet.plan import Plan

MAX_FEATURES_3D = 320  # Generic_UNet.MAX_NUM_FILTERS_3D


def load_nnunet_plans(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def plan_from_nnunet_plans(plans: dict, pad_style: str = "torch") -> Plan:
    """The Plan of an nnU-Net plans.pkl dict (the fork trains '3d_fullres',
    the last entry of ``plans_per_stage``)."""
    per_stage = plans["plans_per_stage"]
    st = per_stage[sorted(per_stage.keys())[-1]]
    pool = [[int(v) for v in k] for k in st["pool_op_kernel_sizes"]]
    conv = [[int(v) for v in k] for k in st["conv_kernel_sizes"]]
    # nnU-Net emits one conv kernel per stage (num_pools + 1); a truncated
    # list repeats its last entry
    while len(conv) < len(pool) + 1:
        conv.append(conv[-1])
    return Plan(
        target_spacing=[float(s) for s in st["current_spacing"]],
        patch_size=[int(p) for p in st["patch_size"]],
        batch_size=int(st.get("batch_size", 2)),
        pool_kernels=pool,
        conv_kernels=conv[: len(pool) + 1],
        base_features=int(plans.get("base_num_features", 32)),
        max_features=MAX_FEATURES_3D,
        # nnU-Net plans count foreground classes; the network adds background
        num_classes=int(plans["num_classes"]) + 1,
        in_channels=int(plans.get("num_modalities", 1)),
        normalization="zscore",
        median_shape=[int(v) for v in st.get("median_patient_size_in_voxels", [0, 0, 0])],
        pad_style=pad_style,
    )


def state_dict_from_nnunet(state_dict: dict, plan: Plan) -> dict:
    """Map a Generic_UNet state_dict onto the port's ``UNet3D`` state_dict
    (float32 CPU tensors).

    Generic_UNet (nnUNetTrainerV2, conv_per_stage=2, convolutional pooling
    and upsampling):
      conv_blocks_context.{s}.blocks.{0,1}.(conv|instnorm)   s in 0..P-1
      conv_blocks_context.{P}.{0,1}.blocks.0.(conv|instnorm) bottleneck
      tu.{u}                                                 u=0 deepest
      conv_blocks_localization.{u}.{0,1}.blocks.0.(conv|instnorm)
      seg_outputs.{u}                                        u=0 deepest
    UNet3D: ``blocks.{n}`` in creation order (encoder stage i -> 2i, 2i+1;
    decoder u -> 2P+2+2u, 2P+3+2u), ``ups.{u}``, ``heads.{P-1-u}``."""
    # DataParallel-trained checkpoints prefix every key with "module."
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}
    P = plan.num_pools
    out = {}
    consumed = set()

    def get(key):
        consumed.add(key)
        if key not in sd:
            near = sorted(k for k in sd if k.split(".")[0] == key.split(".")[0])
            raise KeyError(
                "state_dict key %r not found — the checkpoint's layout "
                "doesn't match Generic_UNet (conv_per_stage=2, convolutional "
                "pooling/upsampling). Nearby keys: %s" % (key, near[:8]))
        return sd[key]

    def block(n, src):
        out["blocks.%d.conv.weight" % n] = get(src + ".conv.weight")
        out["blocks.%d.conv.bias" % n] = get(src + ".conv.bias")
        out["blocks.%d.norm_weight" % n] = get(src + ".instnorm.weight")
        out["blocks.%d.norm_bias" % n] = get(src + ".instnorm.bias")

    for s in range(P):  # encoder stages: one StackedConvLayers of two blocks
        for b in range(2):
            block(2 * s + b, "conv_blocks_context.%d.blocks.%d" % (s, b))
    for b in range(2):  # bottleneck: two single-block StackedConvLayers
        block(2 * P + b, "conv_blocks_context.%d.%d.blocks.0" % (P, b))
    for u in range(P):
        out["ups.%d.weight" % u] = get("tu.%d.weight" % u)
        for b in range(2):
            block(2 * P + 2 + 2 * u + b, "conv_blocks_localization.%d.%d.blocks.0" % (u, b))
        level = P - 1 - u
        out["heads.%d.weight" % level] = get("seg_outputs.%d.weight" % u)
        bias_key = "seg_outputs.%d.bias" % u
        if bias_key in sd:
            out["heads.%d.bias" % level] = get(bias_key)
        else:
            out["heads.%d.bias" % level] = np.zeros(plan.num_classes, np.float32)

    # every weight must land somewhere: a variant with extra layers (say
    # conv_per_stage=3) would otherwise convert into another function
    leftover = sorted(k for k in sd if k not in consumed and not k.endswith("num_batches_tracked"))
    if leftover:
        raise RuntimeError(
            "checkpoint has %d weight tensors this converter did not map "
            "(unsupported architecture variant): %s%s"
            % (len(leftover), ", ".join(leftover[:6]), ", ..." if len(leftover) > 6 else ""))
    out = {k: v.detach().to("cpu", torch.float32).clone() if torch.is_tensor(v)
           else torch.from_numpy(np.array(v, np.float32))
           for k, v in out.items()}
    want = {k: tuple(v.shape) for k, v in UNet3D(plan).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise RuntimeError(
            "the checkpoint's tensors do not fit the plan's network: %s"
            % ", ".join("%s %s (plan %s)" % (k, got.get(k), want.get(k)) for k in bad[:6]))
    return out


def find_nnunet_model(root: str, which: str = None) -> str:
    """The nnU-Net checkpoint under a reference model install, or ``root``
    itself when it is a file. ``which`` pins a file name (say
    'model_latest.model'); by default model_best, then final, then latest.
    Several matches (multi-task or multi-fold installs) are an error, not an
    arbitrary pick."""
    if os.path.isfile(root):
        return root
    if not os.path.isdir(root):
        raise RuntimeError('Directory not exist: "%s".' % root)
    names = [which] if which else [
        "model_best.model", "model_final_checkpoint.model", "model_latest.model"]
    for name in names:
        found = sorted(os.path.join(dirpath, name)
                       for dirpath, _dirs, files in os.walk(root) if name in files)
        if len(found) > 1:
            raise RuntimeError("several %s checkpoints under %s: %s — point -i at one of "
                               "them directly." % (name, root, ", ".join(found)))
        if found:
            return found[0]
    raise RuntimeError("no nnU-Net checkpoint (%s) found under %s" % ("/".join(names), root))


def find_nnunet_plans(model_path: str, root: str = None) -> str:
    """The plans pickle of a checkpoint: plans.pkl in the fold directory or
    up to three levels above it, else the one *_plans_3D.pkl / plans.pkl
    under the search root. Several are an error (another task's plans
    change the spacing and patch geometry): pass -p to pin one."""
    d = os.path.dirname(os.path.abspath(model_path))
    for _up in range(4):
        cand = os.path.join(d, "plans.pkl")
        if os.path.isfile(cand):
            return cand
        d = os.path.dirname(d)
    top = root if root and os.path.isdir(root) else os.path.dirname(os.path.abspath(model_path))
    cands = sorted(os.path.join(dirpath, name)
                   for dirpath, _dirs, files in os.walk(top) for name in files
                   if name.endswith("_plans_3D.pkl") or name == "plans.pkl")
    if len(cands) == 1:
        return cands[0]
    if not cands:
        raise RuntimeError("no plans.pkl found for checkpoint %s — pass -p explicitly"
                           % model_path)
    raise RuntimeError("several plans files near %s: %s — pass -p to pick one."
                       % (model_path, ", ".join(cands)))


def find_nnunet_checkpoint(root: str, which: str = None):
    """(model_path, plans_path) of a reference install."""
    model = find_nnunet_model(root, which)
    return model, find_nnunet_plans(model, root if os.path.isdir(root) else None)


def convert_nnunet_model(model_path: str, plans_path: str, out_folder: str) -> str:
    """Convert a reference torch checkpoint into a model package that both
    packages' ``load_released_model`` read; the weights are always written
    as model_best, the name every loader expects. Returns the folder."""
    plans = load_nnunet_plans(plans_path)
    plan = plan_from_nnunet_plans(plans)
    # this package z-scores over the whole volume (nnU-Net's nonCT path with
    # use_nonzero_mask=False); plans that normalised within a nonzero mask
    # saw other input statistics in training
    mask_norm = plans.get("use_mask_for_norm") or {}
    if any(bool(v) for v in (mask_norm.values() if isinstance(mask_norm, dict) else [mask_norm])):
        warnings.warn(
            "this checkpoint's plans used nonzero-mask normalization "
            "(use_mask_for_norm=True); this framework normalizes over the "
            "whole volume, so inference inputs will be scaled slightly "
            "differently than in training.")
    blob = torch.load(model_path, map_location="cpu", weights_only=False)
    state_dict = blob["state_dict"] if "state_dict" in blob else blob
    sd = state_dict_from_nnunet(state_dict, plan)

    out = mkdir(out_folder)
    meta = {"converted_from": os.path.basename(model_path),
            "epoch": int(blob.get("epoch", -1)) if isinstance(blob, dict) else -1}
    ckpt.save_checkpoint(out, ckpt.MODEL_BEST, ckpt.params_to_flax(sd), meta=meta)
    plan.save(os.path.join(out, release.PLAN_FILE))
    atomic_write_json({"package": release.PACKAGE_FORMAT, "version": __version__, "format": 1,
                       "converted_from_torch": True},
                      os.path.join(out, release.MANIFEST))
    release.validate_model_dir(out)
    return out
