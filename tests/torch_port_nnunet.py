"""A PyTorch replica of the reference nnU-Net fork's Generic_UNet at any
plan's widths, seeded weights and the reference's install layout: the
scaffolding behind the checkpoint-conversion tests and ``chip_smoke.py``'s
``convert_evaluate`` phase. The module nesting is the fork's, so the
state_dict keys are those of real checkpoints
(``conv_blocks_context.{s}.blocks.{b}``, the bottleneck's Sequential pair,
``tu.{u}``, ``conv_blocks_localization.{u}.{0,1}``, ``seg_outputs.{u}``).
It imports torch only."""

from __future__ import annotations

import os
import pickle

import torch
import torch.nn as tnn

TRAINER = "nnUNetTrainerV2__nnUNetPlansv2.1"


class _Block(tnn.Module):
    """ConvDropoutNormNonlin: conv -> InstanceNorm3d(affine) -> LeakyReLU."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv = tnn.Conv3d(cin, cout, tuple(k), tuple(stride),
                               padding=tuple(x // 2 for x in k))
        self.instnorm = tnn.InstanceNorm3d(cout, affine=True, eps=1e-5)
        self.lrelu = tnn.LeakyReLU(0.01, inplace=True)

    def forward(self, x):
        return self.lrelu(self.instnorm(self.conv(x)))


class _Stacked(tnn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = tnn.Sequential(*blocks)

    def forward(self, x):
        return self.blocks(x)


class GenericUNetReplica(tnn.Module):
    """Generic_UNet with conv_per_stage=2, convolutional pooling and
    upsampling, bias-free segmentation heads. ``forward`` returns every
    level's logits, deepest first (the last is full resolution)."""

    def __init__(self, pools, convs, base=32, num_classes=2, in_channels=1, max_features=320):
        super().__init__()
        P = len(pools)
        self.P = P

        def feats(stage):
            return min(base * 2 ** stage, max_features)

        ctx = []
        cin = in_channels
        for s in range(P):
            stride = pools[s - 1] if s > 0 else (1, 1, 1)
            ctx.append(_Stacked([_Block(cin, feats(s), convs[s], stride),
                                 _Block(feats(s), feats(s), convs[s], (1, 1, 1))]))
            cin = feats(s)
        ctx.append(tnn.Sequential(
            _Stacked([_Block(cin, feats(P), convs[P], pools[P - 1])]),
            _Stacked([_Block(feats(P), feats(P), convs[P], (1, 1, 1))]),
        ))
        self.conv_blocks_context = tnn.ModuleList(ctx)
        tu, loc, heads = [], [], []
        for u in range(P):
            below, skip, pool = feats(P - u), feats(P - 1 - u), pools[P - 1 - u]
            tu.append(tnn.ConvTranspose3d(below, skip, tuple(pool), tuple(pool), bias=False))
            loc.append(tnn.Sequential(
                _Stacked([_Block(2 * skip, skip, convs[P - 1 - u], (1, 1, 1))]),
                _Stacked([_Block(skip, skip, convs[P - 1 - u], (1, 1, 1))]),
            ))
            heads.append(tnn.Conv3d(skip, num_classes, 1, bias=False))
        self.tu = tnn.ModuleList(tu)
        self.conv_blocks_localization = tnn.ModuleList(loc)
        self.seg_outputs = tnn.ModuleList(heads)

    def forward(self, x):
        skips = []
        for s in range(self.P):
            x = self.conv_blocks_context[s](x)
            skips.append(x)
        x = self.conv_blocks_context[self.P](x)
        segs = []
        for u in range(self.P):
            x = torch.cat([self.tu[u](x), skips[self.P - 1 - u]], dim=1)
            x = self.conv_blocks_localization[u](x)
            segs.append(self.seg_outputs[u](x))
        return segs


def seeded_replica(pools, convs, base=32, num_classes=2, seed=0, **kw) -> GenericUNetReplica:
    """A replica in eval mode whose every tensor is drawn from one
    ``torch.Generator(seed)``: weights and biases uniform in +-1/sqrt(fan
    in), instance-norm scales in [0.5, 1.5) and biases ~ N(0, 0.1^2), so
    a conversion that ignored the norm affines could not pass."""
    net = GenericUNetReplica(pools, convs, base, num_classes, **kw).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (tnn.Conv3d, tnn.ConvTranspose3d)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=g) * 2 - 1) * bound)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=g) * 2 - 1) * bound)
            elif isinstance(m, tnn.InstanceNorm3d):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return net


def plans_dict(pools, convs, patch, spacing, base=32, num_classes=2) -> dict:
    """An nnU-Net plans.pkl dict whose last (3d_fullres) stage has these
    pools, convs, patch and spacing, behind a coarser stage 0."""
    return {
        "plans_per_stage": {
            0: {"patch_size": [8, 8, 8], "current_spacing": [2.0 * s for s in spacing],
                "pool_op_kernel_sizes": [[2, 2, 2]],
                "conv_kernel_sizes": [[3, 3, 3], [3, 3, 3]], "batch_size": 2},
            1: {"patch_size": list(patch), "current_spacing": list(spacing),
                "pool_op_kernel_sizes": [list(p) for p in pools],
                "conv_kernel_sizes": [list(c) for c in convs], "batch_size": 2,
                "median_patient_size_in_voxels": list(patch)},
        },
        "base_num_features": base,
        "num_classes": num_classes - 1,  # nnU-Net counts foreground only
        "num_modalities": 1,
    }


def write_reference_install(root, net, plans, task="Task002_FinalModel", epoch=5) -> str:
    """Save ``net`` as ``{"epoch", "state_dict"}`` model_best.model and
    ``plans`` as plans.pkl in the reference's install layout under
    ``root``; returns the fold folder."""
    trainer = os.path.join(root, "nnUNet", "3d_fullres", task, TRAINER)
    fold = os.path.join(trainer, "all")
    os.makedirs(fold, exist_ok=True)
    torch.save({"epoch": epoch, "state_dict": net.state_dict()},
               os.path.join(fold, "model_best.model"))
    with open(os.path.join(trainer, "plans.pkl"), "wb") as f:
        pickle.dump(plans, f)
    return fold
