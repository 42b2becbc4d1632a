"""Plan-driven 3D U-Net in PyTorch, the port of ``deepwmh_tpu.unet.model``.

Same topology and numerics as the flax model: conv-downsample encoder,
transpose-conv decoder with skip concatenation, instance norm + leaky ReLU,
a 1x1x1 head at every level; bf16 compute with f32 parameters and f32
normalisation statistics. The module takes and returns torch's NCDHW, with
activations kept in ``torch.channels_last_3d`` memory: then
``x.permute(0, 2, 3, 4, 1)`` is the JAX layout [N, D, H, W, C] with no copy,
and the instance-norm statistics kernel (K1, ``ops/kernels.py``) reads the
activation in place.

The flax model's depth-decomposed full-resolution conv is a TPU lowering of
the same math; here every conv is one ``F.conv3d``. Parameter names map
one-to-one onto the flax tree (``unet/checkpoint.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deepwmh_tpu_torch.ops.kernels import instance_norm_stats
from deepwmh_tpu_torch.unet.plan import Plan, features_per_stage

LRELU_SLOPE = 0.01
NORM_EPS = 1e-5


def _same_pads(size: int, k: int, s: int):
    """XLA SAME padding of one axis: asymmetric (more at the end) when a
    strided window does not tile an even input."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv3D(nn.Module):
    """3D conv with XLA SAME geometry (``pad_style="same"``) or torch's
    symmetric k//2 padding on strided convs (``pad_style="torch"``, the
    geometry of models converted from PyTorch nnU-Net checkpoints)."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1),
                 dtype=torch.bfloat16, pad_style="same"):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(int(s) for s in stride)
        self.dtype = dtype
        self.pad_style = pad_style
        self.weight = nn.Parameter(torch.empty((cout, cin) + self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = _weight(self.weight, self.dtype)
        x = x.to(self.dtype)
        if self.pad_style == "torch" and any(s > 1 for s in self.stride):
            y = F.conv3d(x, w, None, self.stride, tuple(k // 2 for k in self.kernel))
        else:
            pads = [_same_pads(int(x.shape[2 + a]), self.kernel[a], self.stride[a])
                    for a in range(3)]
            if all(lo == hi for lo, hi in pads):
                y = F.conv3d(x, w, None, self.stride, tuple(lo for lo, _ in pads))
            else:
                flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # (W, H, D)
                y = F.conv3d(F.pad(x, flat), w, None, self.stride, 0)
        # bias added in the compute dtype after the conv, as flax does
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)


def _weight(w, dtype):
    """A kernel in the compute dtype and channels-last memory: with the
    input channels-last too, the conv's output stays channels-last."""
    return w.to(dtype, memory_format=torch.channels_last_3d)


def _leaky_slope(dtype) -> float:
    """The slope as the compute dtype holds it: flax multiplies by the
    weakly-typed 0.01 cast to that dtype."""
    return float(torch.tensor(LRELU_SLOPE, dtype=dtype))


class ConvNormAct(nn.Module):
    """Conv -> instance norm (statistics from K1) -> leaky ReLU."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1),
                 dtype=torch.bfloat16, pad_style="same"):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3D(cin, cout, kernel, stride, dtype, pad_style)
        self.norm_weight = nn.Parameter(torch.ones(cout))
        self.norm_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = self.conv(x)
        n, c = y.shape[:2]
        mean, var = instance_norm_stats(y.permute(0, 2, 3, 4, 1))
        # flax GroupNorm: var clamped at 0, then
        # (x - mean) * (scale * rsqrt(var + eps)) + bias in f32, cast down
        mul = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS) * self.norm_weight
        bc = (n, c, 1, 1, 1)
        # in place on the one f32 copy: saves two activation-sized buffers
        z = y.float()
        z.sub_(mean.view(bc)).mul_(mul.view(bc)).add_(self.norm_bias.view(1, c, 1, 1, 1))
        return F.leaky_relu(z.to(self.dtype), _leaky_slope(self.dtype))


class UNet3D(nn.Module):
    """Plan-configured 3D U-Net.

    forward(x: [N, C_in, D, H, W]) -> f32 logits [N, num_classes, D, H, W]
    at full resolution, or with ``deep_supervision=True`` the list of every
    level's logits, highest resolution first."""

    def __init__(self, plan: Plan, dtype=torch.bfloat16):
        super().__init__()
        self.plan = plan
        self.dtype = dtype
        feats = features_per_stage(plan)
        P = plan.num_pools
        pad = getattr(plan, "pad_style", "same")
        blocks = []
        cin = int(plan.in_channels)
        for i in range(P + 1):
            stride = plan.pool_kernels[i - 1] if i > 0 else (1, 1, 1)
            blocks.append(ConvNormAct(cin, feats[i], plan.conv_kernels[i], stride, dtype, pad))
            blocks.append(ConvNormAct(feats[i], feats[i], plan.conv_kernels[i], (1, 1, 1), dtype, pad))
            cin = feats[i]
        ups = []
        heads = [None] * max(P, 1)
        if P == 0:
            heads[0] = nn.Conv3d(cin, plan.num_classes, 1)
        for i in range(P - 1, -1, -1):
            pk = tuple(int(k) for k in plan.pool_kernels[i])
            ups.append(nn.ConvTranspose3d(cin, feats[i], pk, pk, bias=False))
            blocks.append(ConvNormAct(2 * feats[i], feats[i], plan.conv_kernels[i], (1, 1, 1), dtype, pad))
            blocks.append(ConvNormAct(feats[i], feats[i], plan.conv_kernels[i], (1, 1, 1), dtype, pad))
            heads[i] = nn.Conv3d(feats[i], plan.num_classes, 1)
            cin = feats[i]
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.heads = nn.ModuleList(heads)

    def _head(self, i, x):
        h = self.heads[i]
        y = F.conv3d(x, _weight(h.weight, self.dtype))
        return (y + h.bias.to(self.dtype).view(1, -1, 1, 1, 1)).float()

    def forward(self, x, deep_supervision: bool = False):
        plan = self.plan
        P = plan.num_pools
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last_3d)
        blocks = iter(self.blocks)
        skips = []
        for i in range(P + 1):
            x = next(blocks)(x)
            x = next(blocks)(x)
            if i < P:
                skips.append(x)
        outputs = [self._head(0, x)] if P == 0 else []
        for u, i in enumerate(range(P - 1, -1, -1)):
            x = F.conv_transpose3d(x, _weight(self.ups[u].weight, self.dtype),
                                   stride=tuple(int(k) for k in plan.pool_kernels[i]))
            x = torch.cat([x, skips[i]], dim=1)
            x = next(blocks)(x)
            x = next(blocks)(x)
            if deep_supervision or i == 0:  # the deeper heads only feed training
                outputs.append(self._head(i, x))
        outputs.reverse()
        return outputs if deep_supervision else outputs[0]


def init_weights(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """Random weights from ``generator``: LeCun-normal kernels (fan-in
    scaled, as flax initialises), zero biases, unit norm scales."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm_weight"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                # ConvTranspose3d stores [in, out, k...]; the others [out, in, k...]
                cin = p.shape[0] if name.startswith("ups.") else p.shape[1]
                fan_in = int(cin) * math.prod(p.shape[2:])
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
    return model
