"""The first steps of the port's ``Trainer.fit`` in plain float32 PyTorch:
the benchmark's reference for the train cells.

It works out again what the trainer derives from the benchmark's cases and
seed: the initial weights (``init_weights`` from the CPU generator), the
batches (``SegDataset.sample_batch`` from ``RandomState(seed)``), the
augmentation (``augment_samples`` from a generator on the device seeded
with ``seed``), then per step the deep-supervision CE + batch Dice loss,
its gradient and nnU-Net's update, written out as the port's docstring
states it (``replay_step`` takes one such step from a run's own state):

    g <- g                 if ||g|| < clip, else g / ||g|| * clip
    u  = g + wd * p
    t <- u + m * t
    p <- p + (u + m * t) * (-lr)

with the poly LR ``lr * (1 - step / total)^0.9`` rounded to f32.
"""

from __future__ import annotations

import numpy as np
import torch

from wmhbench.reference.augment import AugmentConfig, augment_samples
from wmhbench.reference.data import SegDataset
from wmhbench.reference.losses import deep_supervision_loss
from wmhbench.reference.unet import UNet3D, init_weights


def lr_at(step: int, lr: float, total: int) -> float:
    return float(np.float32(lr * (1.0 - step / max(total, 1)) ** 0.9))


def _step(model, params, trace, images, labels, gen, plan: dict, hyper: dict, lr: float):
    """One step on a host-sampled batch already on the device: augment,
    forward, loss, gradient, clip, update (in place). Returns the loss and
    the gradient after the clip, as the update takes it."""
    images, labels = augment_samples(gen, images, labels, AugmentConfig())
    outs = model(images[:, None], deep_supervision=True)
    loss = deep_supervision_loss(outs, labels, plan["pool_kernels"])
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    m, wd, clip = hyper["momentum"], hyper["weight_decay"], hyper["grad_clip"]
    with torch.no_grad():
        g_norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        keep = g_norm < clip
        grads = [torch.where(keep, g, g / g_norm * clip) for g in grads]
        for p, g, t in zip(params, grads, trace):
            u = g + wd * p
            t.mul_(m).add_(u)
            p.add_((u + m * t) * (-lr))
    return float(loss.detach()), grads


def first_steps(plan: dict, hyper: dict, cases, seed: int, steps: int, device,
                precision: str = "f32") -> dict:
    """``steps`` training steps from scratch. ``hyper``: batch_size,
    oversample_fg, lr, momentum, weight_decay, grad_clip, total_steps.
    ``cases``: [(name, image, label)] numpy. Returns {"names", "losses",
    "p0", "grad1" (the first step's gradient after the clip, as the update
    takes it), "p_end"}, tensors on the CPU."""
    model = UNet3D(plan, precision)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    p0 = [p.detach().cpu().clone() for p in params]
    trace = [torch.zeros_like(p) for p in params]
    ds = SegDataset(plan["patch_size"])
    for name, image, label in cases:
        ds.add_case(name, image, label)
    np_rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, grad1 = [], None
    for step in range(steps):
        images, labels = ds.sample_batch(np_rng, hyper["batch_size"], hyper["oversample_fg"])
        images = torch.from_numpy(images).to(device)
        labels = torch.from_numpy(labels).to(device)
        loss, grads = _step(model, params, trace, images, labels, gen, plan, hyper,
                            lr_at(step, hyper["lr"], hyper["total_steps"]))
        if step == 0:
            grad1 = [g.cpu() for g in grads]
        losses.append(loss)
    return {"names": names, "losses": losses, "p0": p0, "grad1": grad1,
            "p_end": [p.detach().cpu().clone() for p in params]}


def replay_step(plan: dict, hyper: dict, step: int, state: dict, device,
                precision: str = "f32") -> dict:
    """Step ``step`` (counted from 0) of a run, taken from that run's own
    state before it. ``state``: "params" and "trace" (lists in parameter
    order), the step's host-sampled "images" and "labels", and "gen", the
    augmentation generator's state. Returns {"loss", "grad" (after the
    clip), "p_end"}, tensors on the CPU."""
    model = UNet3D(plan, precision).to(device)
    params = [p for _, p in model.named_parameters()]
    with torch.no_grad():
        for p, v in zip(params, state["params"], strict=True):
            p.copy_(v)
    trace = [t.to(device, torch.float32, copy=True) for t in state["trace"]]
    gen = torch.Generator(device=device)
    gen.set_state(state["gen"])
    loss, grads = _step(model, params, trace, state["images"].to(device),
                        state["labels"].to(device), gen, plan, hyper,
                        lr_at(step, hyper["lr"], hyper["total_steps"]))
    return {"loss": loss, "grad": [g.cpu() for g in grads],
            "p_end": [p.detach().cpu().clone() for p in params]}
