"""Model packages: validate, resolve, load, write, release and install.

A released model is a folder holding ``plan.json``, ``model_best.msgpack``
(+ ``.json`` metadata) and a ``framework.json`` manifest — the layout
``deepwmh_tpu.unet.release`` writes. The format is shared by both packages,
so the manifest names ``"package": "deepwmh_tpu"`` whichever wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import tarfile

import torch

from deepwmh_tpu_torch import __version__
from deepwmh_tpu_torch.core.artifacts import atomic_write_json, mkdir
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.unet import checkpoint as ckpt
from deepwmh_tpu_torch.unet.model import UNet3D
from deepwmh_tpu_torch.unet.plan import Plan

MANIFEST = "framework.json"
PLAN_FILE = "plan.json"
PACKAGE_FORMAT = "deepwmh_tpu"
RELEASE_TARBALL = "model_release.tar.gz"


def validate_model_dir(folder: str) -> None:
    missing = [
        f
        for f in (PLAN_FILE, ckpt.MODEL_BEST + ".msgpack")
        if not os.path.isfile(os.path.join(folder, f))
    ]
    if missing:
        raise RuntimeError(
            "invalid model directory %s: missing %s" % (folder, ", ".join(missing))
        )
    manifest = os.path.join(folder, MANIFEST)
    if os.path.isfile(manifest):
        with open(manifest) as f:
            meta = json.load(f)
        if meta.get("package") != PACKAGE_FORMAT:
            raise RuntimeError("not a deepwmh_tpu model package: %s" % folder)


def resolve_model_dir(folder: str, task_name: str | None = None) -> str:
    """Resolve ``-m`` to a concrete model package: a package folder resolves
    to itself; a model root holding exactly one task folder resolves to it;
    several need ``task_name`` (``--custom-task-name``)."""
    if not os.path.isdir(folder):
        raise RuntimeError('Directory not exist: "%s".' % folder)
    if task_name is not None:
        cand = os.path.join(folder, task_name)
        if not os.path.isdir(cand):
            raise RuntimeError(
                'task folder "%s" not found in "%s"' % (task_name, folder))
        validate_model_dir(cand)
        return cand
    if os.path.isfile(os.path.join(folder, PLAN_FILE)):
        validate_model_dir(folder)
        return folder
    tasks = sorted(
        d for d in os.listdir(folder)
        if os.path.isfile(os.path.join(folder, d, PLAN_FILE))
    )
    if len(tasks) == 0:
        # the standard invalid-package error for `folder`
        validate_model_dir(folder)
        return folder
    if len(tasks) > 1:
        raise RuntimeError(
            'Found multiple task folders in "%s": %s — select one with '
            "--custom-task-name." % (folder, ", ".join(tasks)))
    task = os.path.join(folder, tasks[0])
    validate_model_dir(task)
    return task


def load_released_model(folder: str, checkpoint_name: str = ckpt.MODEL_BEST,
                        device=None, dtype=torch.bfloat16):
    """Returns (model, plan): the UNet3D with the package's weights, in eval
    mode with channels-last parameters on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    validate_model_dir(folder)
    plan = Plan.load(os.path.join(folder, PLAN_FILE))
    model = UNet3D(plan, dtype=dtype)
    state = ckpt.params_from_flax(ckpt.load_flax_params(folder, checkpoint_name))
    model.load_state_dict(state, strict=True)
    model = model.to(dev, memory_format=torch.channels_last_3d).eval()
    return model, plan


def _write_manifest(out: str) -> None:
    atomic_write_json({"package": PACKAGE_FORMAT, "version": __version__, "format": 1},
                      os.path.join(out, MANIFEST))


def release_model(train_dir: str, plan: Plan, out_folder: str, make_tarball=True) -> str:
    """Collect a training folder's model_best and ``plan`` into a model
    package at ``out_folder`` and, by default, compress it into
    ``model_release.tar.gz`` there. Returns the tarball path (the folder
    with make_tarball=False)."""
    out = mkdir(out_folder)
    if not ckpt.checkpoint_exists(train_dir, ckpt.MODEL_BEST):
        raise RuntimeError("no %s checkpoint in %s — train the pipeline first"
                           % (ckpt.MODEL_BEST, train_dir))
    for suffix in (".msgpack", ".json"):
        src = os.path.join(train_dir, ckpt.MODEL_BEST + suffix)
        if os.path.isfile(src):
            shutil.copyfile(src, os.path.join(out, ckpt.MODEL_BEST + suffix))
    plan.save(os.path.join(out, PLAN_FILE))
    _write_manifest(out)
    if not make_tarball:
        return out
    tarball = os.path.join(out, RELEASE_TARBALL)
    if os.path.isfile(tarball):
        os.remove(tarball)
    with tarfile.open(tarball, "w:gz") as tf:
        for name in os.listdir(out):
            if name != RELEASE_TARBALL:
                tf.add(os.path.join(out, name), arcname=name)
    return tarball


def install_model(tarball: str, dest_folder: str) -> str:
    """Unpack a released model into ``dest_folder`` and validate it (the
    package is relocatable: installing is extracting)."""
    dest = mkdir(dest_folder)
    with tarfile.open(tarball, "r:gz") as tf:
        tf.extractall(dest, filter="data")
    validate_model_dir(dest)
    return dest


def write_model_package(folder: str, model: UNet3D, plan: Plan,
                        meta: dict | None = None) -> str:
    """Write ``model``'s weights and ``plan`` as a model package that both
    this package and deepwmh_tpu load."""
    out = mkdir(folder)
    ckpt.save_checkpoint(out, ckpt.MODEL_BEST,
                         ckpt.params_to_flax(model.state_dict()), meta=meta)
    plan.save(os.path.join(out, PLAN_FILE))
    _write_manifest(out)
    return out
