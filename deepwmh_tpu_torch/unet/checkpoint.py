"""Checkpoint I/O and the weight carry-over between flax and PyTorch.

A checkpoint is ``<name>.msgpack`` (flax ``to_bytes`` of ``{"params": tree}``,
with ``"opt_state"`` beside it in a training checkpoint, read and written
here with the stdlib codec in ``msgpack_codec``) plus a ``<name>.json``
metadata sidecar, exactly as ``deepwmh_tpu.unet.checkpoint`` writes it, so a
model trained by either package runs in the other and either trainer
resumes the other's ``model_latest``.

``params_from_flax`` maps the flax parameter tree (numpy leaves) onto the
port's ``UNet3D`` state_dict; ``params_to_flax`` is its inverse:

- conv kernels ``[kd,kh,kw,in,out]`` <-> ``[out,in,kd,kh,kw]``;
- ConvTranspose kernels ``[kd,kh,kw,in,out]`` <-> torch's ``[in,out,kd,kh,kw]``
  with the spatial axes flipped (``lax.conv_transpose`` correlates where
  torch's transposed convolution convolves);
- ``GroupNorm_0.scale/bias`` <-> the block's ``norm_weight/norm_bias``;
- ``seg_head_{i}`` keeps its bias.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np
import torch

from deepwmh_tpu_torch.core.artifacts import atomic_write_json, load_json
from deepwmh_tpu_torch.unet import msgpack_codec

MODEL_BEST = "model_best"
MODEL_LATEST = "model_latest"
MODEL_EPOCH_FMT = "model_ep_%04d"

_BLOCK = re.compile(r"^ConvNormAct_(\d+)$")
_UP = re.compile(r"^ConvTranspose_(\d+)$")
_HEAD = re.compile(r"^seg_head_(\d+)$")


def _conv_to_torch(k):
    return np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))


def _conv_to_flax(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def _convT_to_torch(k):
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))


def _convT_to_flax(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1])


def params_from_flax(tree: dict) -> dict:
    """flax UNet3D params (nested dict of numpy arrays) -> port state_dict
    (float32 CPU tensors). Raises on a name the port does not know."""
    sd = {}
    for name, sub in tree.items():
        if m := _BLOCK.match(name):
            p = "blocks.%s." % m.group(1)
            sd[p + "conv.weight"] = _conv_to_torch(sub["Conv_0"]["kernel"])
            sd[p + "conv.bias"] = sub["Conv_0"]["bias"]
            sd[p + "norm_weight"] = sub["GroupNorm_0"]["scale"]
            sd[p + "norm_bias"] = sub["GroupNorm_0"]["bias"]
        elif m := _UP.match(name):
            sd["ups.%s.weight" % m.group(1)] = _convT_to_torch(sub["kernel"])
        elif m := _HEAD.match(name):
            p = "heads.%s." % m.group(1)
            sd[p + "weight"] = _conv_to_torch(sub["kernel"])
            sd[p + "bias"] = sub["bias"]
        else:
            raise KeyError("unknown flax parameter scope %r" % name)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def params_to_flax(state_dict: dict) -> dict:
    """Inverse of params_from_flax: port state_dict -> flax param tree of
    numpy arrays that share no memory with the tensors (a CPU model that
    trains on must not change a tree taken before)."""
    tree = {}
    for key, t in state_dict.items():
        v = t.detach().to("cpu", torch.float32).numpy().copy()
        kind, idx, leaf = key.split(".", 2)
        if kind == "blocks":
            node = tree.setdefault("ConvNormAct_%s" % idx, {})
            if leaf == "conv.weight":
                node.setdefault("Conv_0", {})["kernel"] = _conv_to_flax(v)
            elif leaf == "conv.bias":
                node.setdefault("Conv_0", {})["bias"] = v
            elif leaf == "norm_weight":
                node.setdefault("GroupNorm_0", {})["scale"] = v
            elif leaf == "norm_bias":
                node.setdefault("GroupNorm_0", {})["bias"] = v
            else:
                raise KeyError("unknown block parameter %r" % key)
        elif kind == "ups" and leaf == "weight":
            tree["ConvTranspose_%s" % idx] = {"kernel": _convT_to_flax(v)}
        elif kind == "heads" and leaf in ("weight", "bias"):
            node = tree.setdefault("seg_head_%s" % idx, {})
            node["kernel" if leaf == "weight" else "bias"] = (
                _conv_to_flax(v) if leaf == "weight" else v)
        else:
            raise KeyError("unknown parameter %r" % key)
    return tree


def checkpoint_exists(folder: str, name: str) -> bool:
    return os.path.isfile(os.path.join(folder, name + ".msgpack"))


def load_checkpoint(folder: str, name: str):
    """(params tree, optimizer state tree or None, meta) of
    ``<folder>/<name>``, trees with numpy leaves in flax's layout."""
    with open(os.path.join(folder, name + ".msgpack"), "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    meta_path = os.path.join(folder, name + ".json")
    meta = load_json(meta_path) if os.path.isfile(meta_path) else {}
    return payload["params"], payload.get("opt_state"), meta


def load_flax_params(folder: str, name: str = MODEL_BEST) -> dict:
    """The raw flax param tree (numpy leaves) of ``<folder>/<name>.msgpack``."""
    return load_checkpoint(folder, name)[0]


def save_checkpoint(folder: str, name: str, params_tree: dict, opt_state=None,
                    meta: dict = None):
    """Write ``{"params": params_tree}`` (and ``"opt_state"`` when given, a
    tree in flax's ``to_state_dict`` layout) as flax msgpack plus the JSON
    sidecar, the layout deepwmh_tpu's load_checkpoint reads."""
    os.makedirs(folder, exist_ok=True)
    payload = {"params": params_tree}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = os.path.join(folder, name + ".msgpack.tmp")
    with open(tmp, "wb") as f:
        f.write(msgpack_codec.packb(payload))
    os.replace(tmp, os.path.join(folder, name + ".msgpack"))
    atomic_write_json(meta or {}, os.path.join(folder, name + ".json"))


def link_checkpoint(folder: str, src: str, dst: str):
    """Make ``dst`` an alias of the written ``src`` checkpoint without
    serialising the weights again: hard-link the msgpack (copy where the
    filesystem has no links) and copy the meta json."""
    src_m = os.path.join(folder, src + ".msgpack")
    dst_m = os.path.join(folder, dst + ".msgpack")
    tmp = dst_m + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    try:
        os.link(src_m, tmp)
    except OSError:
        shutil.copyfile(src_m, tmp)
    os.replace(tmp, dst_m)
    src_j = os.path.join(folder, src + ".json")
    if os.path.isfile(src_j):
        shutil.copyfile(src_j, os.path.join(folder, dst + ".json"))
