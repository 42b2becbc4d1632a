"""Frozen copy of the port's ``unet/losses.py`` for the benchmark's reference
(plain PyTorch / numpy; imports nothing of the port). Its docstring as
there:

Segmentation losses: cross-entropy + batch soft Dice with deep
supervision (the port of ``deepwmh_tpu.unet.losses``).

The JAX package reduces [N,D,H,W,C] logits over axes (0,1,2,3); the port's
logits are torch's [N,C,D,H,W], so the class axis is 1 and the voxel axes
are (0,2,3,4). Targets are integer [N,D,H,W].

A data-parallel step needs the loss of the whole batch, not the mean of
the shards' losses: batch Dice is a ratio of sums over the batch. The
``*_parts`` functions give a shard's sums before any ratio, and the
``*_from_parts`` functions the loss from those sums added over the shards.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SMOOTH = 1e-5


def _onehot(target, num_classes: int) -> torch.Tensor:
    """[N,D,H,W] integer -> f32 [N,C,D,H,W]."""
    return F.one_hot(target.long(), num_classes).permute(0, 4, 1, 2, 3).float()


def softmax_ce(logits, target) -> torch.Tensor:
    """Mean voxel cross-entropy. The non-target log-probabilities are
    selected out (not multiplied by 0), so a fully suppressed class (logp =
    -inf) still gives a finite loss."""
    logp = torch.log_softmax(logits.float(), dim=1)
    onehot = _onehot(target, logits.shape[1])
    picked = torch.where(onehot > 0, logp, 0.0)
    return -picked.sum(1).mean()


def soft_dice(logits, target, batch_dice: bool = True) -> torch.Tensor:
    """Soft Dice loss (1 - dice) over the foreground classes; batch_dice
    pools the statistics over the whole batch."""
    probs = torch.softmax(logits.float(), dim=1)
    onehot = _onehot(target, logits.shape[1])
    axes = (0, 2, 3, 4) if batch_dice else (2, 3, 4)
    inter = (probs * onehot).sum(axes)
    denom = probs.sum(axes) + onehot.sum(axes)
    dice = (2 * inter + SMOOTH) / (denom + SMOOTH)
    return 1.0 - dice[..., 1:].mean()


def ce_dice_loss(logits, target, batch_dice: bool = True) -> torch.Tensor:
    return softmax_ce(logits, target) + soft_dice(logits, target, batch_dice)


def ds_weights(num_outputs: int):
    """Deep-supervision weights: 2^-i, the lowest resolution masked out,
    normalised to sum 1."""
    w = [2.0**-i for i in range(num_outputs)]
    if num_outputs > 1:
        w[-1] = 0.0
    s = sum(w)
    return [v / s for v in w]


def downsample_target(target, factor):
    """Nearest-neighbour downsampling of [N,D,H,W] by integer factors."""
    f = tuple(int(v) for v in factor)
    return target[:, :: f[0], :: f[1], :: f[2]]


def deep_supervision_loss(outputs, target, pool_kernels, batch_dice: bool = True):
    """outputs: the logits of every level, highest resolution first; output
    i lives at the cumulative stride prod(pool_kernels[:i])."""
    total = 0.0
    stride = [1, 1, 1]
    for i, (out, w) in enumerate(zip(outputs, ds_weights(len(outputs)))):
        if w > 0:
            total = total + w * ce_dice_loss(out, downsample_target(target, stride), batch_dice)
        if i < len(pool_kernels):
            stride = [s * int(k) for s, k in zip(stride, pool_kernels[i])]
    return total


def ce_dice_parts(logits, target) -> torch.Tensor:
    """The sums of one shard's ``ce_dice_loss`` before any ratio, f32
    [1 + 2C]: the cross-entropy sum over its voxels, then the Dice
    intersection and denominator of every class over its batch rows."""
    logp = torch.log_softmax(logits.float(), dim=1)
    onehot = _onehot(target, logits.shape[1])
    ce_sum = -torch.where(onehot > 0, logp, 0.0).sum()
    probs = torch.softmax(logits.float(), dim=1)
    axes = (0, 2, 3, 4)
    inter = (probs * onehot).sum(axes)
    denom = probs.sum(axes) + onehot.sum(axes)
    return torch.cat([ce_sum.reshape(1), inter, denom])


def ce_dice_from_parts(total, n_voxels: int) -> torch.Tensor:
    """``ce_dice_loss`` (batch Dice) of the whole batch from the shards'
    ``ce_dice_parts`` summed; ``n_voxels`` counts the batch's voxels."""
    C = (total.shape[0] - 1) // 2
    inter, denom = total[1:1 + C], total[1 + C:]
    dice = (2 * inter + SMOOTH) / (denom + SMOOTH)
    return total[0] / n_voxels + (1.0 - dice[1:].mean())


def deep_supervision_parts(outputs, target, pool_kernels) -> torch.Tensor:
    """One shard's ``ce_dice_parts`` of every level with a weight,
    concatenated: what a data-parallel step sums over the shards."""
    parts = []
    stride = [1, 1, 1]
    for i, (out, w) in enumerate(zip(outputs, ds_weights(len(outputs)))):
        if w > 0:
            parts.append(ce_dice_parts(out, downsample_target(target, stride)))
        if i < len(pool_kernels):
            stride = [s * int(k) for s, k in zip(stride, pool_kernels[i])]
    return torch.cat(parts)


def deep_supervision_loss_from_parts(total, level_shapes, batch: int):
    """``deep_supervision_loss`` of a batch of ``batch`` rows from its
    shards' ``deep_supervision_parts`` summed; ``level_shapes``: the
    spatial shape of every level's output, highest resolution first."""
    weighted = [(shape, w) for shape, w in zip(level_shapes, ds_weights(len(level_shapes)))
                if w > 0]
    n = total.shape[0] // len(weighted)  # 1 + 2C a level
    loss = 0.0
    for i, (shape, w) in enumerate(weighted):
        loss = loss + w * ce_dice_from_parts(total[i * n:(i + 1) * n],
                                             batch * math.prod(int(s) for s in shape))
    return loss


def hard_dice_parts(pred, target) -> torch.Tensor:
    """One shard's ``hard_dice`` sums: [intersection, prediction, target]."""
    p = (pred > 0.5).float()
    g = (target > 0.5).float()
    return torch.stack([(p * g).sum(), p.sum(), g.sum()])


def hard_dice_from_parts(total) -> torch.Tensor:
    return (2 * total[0] + SMOOTH) / (total[1] + total[2] + SMOOTH)


def hard_dice(pred, target) -> torch.Tensor:
    """Binary hard Dice for online validation."""
    p = (pred > 0.5).float()
    g = (target > 0.5).float()
    inter = (p * g).sum()
    return (2 * inter + SMOOTH) / (p.sum() + g.sum() + SMOOTH)
