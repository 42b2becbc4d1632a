"""Plan-driven 3D U-Net in PyTorch, the port of ``deepwmh_tpu.unet.model``.

Same topology and numerics as the flax model: conv-downsample encoder,
transpose-conv decoder with skip concatenation, instance norm + leaky ReLU,
a 1x1x1 head at every level; bf16 compute with f32 parameters and f32
normalisation statistics. The module takes and returns torch's NCDHW, with
activations kept in ``torch.channels_last_3d`` memory: then
``x.permute(0, 2, 3, 4, 1)`` is the JAX layout [N, D, H, W, C] with no copy,
and the instance-norm statistics kernel (K1, ``ops/kernels.py``) and the
normalize + leaky ReLU pass that consumes them read the activation in place.

K1's kernels have no backward, so a model built with ``fused_norm=False``
(the trainer's) runs flax GroupNorm's f32 chain out of place instead, which
autograd differentiates; ``remat=True`` recomputes the blocks of the stages
up to ``remat_max_stage`` in the backward pass (``torch.utils.checkpoint``),
as the JAX trainer's ``nn.remat`` does.

The flax model's depth-decomposed full-resolution conv is a TPU lowering of
the same math; here every conv is one ``F.conv3d``. Parameter names map
one-to-one onto the flax tree (``unet/checkpoint.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepwmh_tpu_torch.ops.kernels import instance_norm_act, instance_norm_stats
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
    """Conv -> instance norm -> leaky ReLU. With ``fused_norm`` (inference)
    the statistics come from K1 and the rest from K1's apply pass, neither
    of which autograd can see through; without it, the same math as an
    out-of-place f32 chain that it can."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1),
                 dtype=torch.bfloat16, pad_style="same", fused_norm: bool = True):
        super().__init__()
        self.dtype = dtype
        self.fused_norm = fused_norm
        self.conv = Conv3D(cin, cout, kernel, stride, dtype, pad_style)
        self.norm_weight = nn.Parameter(torch.ones(cout))
        self.norm_bias = nn.Parameter(torch.zeros(cout))
        self.slope = _leaky_slope(dtype)

    def forward(self, x):
        if not self.fused_norm:
            return self._plain(self.conv(x))
        # [N, D, H, W, C] view of the channels-last conv output, no copy
        y = self.conv(x).permute(0, 2, 3, 4, 1)
        mean, var = instance_norm_stats(y)
        # flax GroupNorm: var clamped at 0, then
        # (x - mean) * (scale * rsqrt(var + eps)) + bias in f32, cast down,
        # then the leaky ReLU: one pass (K1's apply kernel on the card)
        mul = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS) * self.norm_weight
        out = instance_norm_act(y, mean, mul, self.norm_bias, self.slope)
        return out.permute(0, 4, 1, 2, 3)

    def _plain(self, y):
        """flax GroupNorm (one channel per group) + leaky ReLU on the conv
        output [N, C, D, H, W]: f32 statistics, var clamped at 0, then
        ((y - mean) * (scale * rsqrt(var + eps)) + bias) in f32, cast to
        the compute dtype."""
        yf = y.float()
        mean = yf.mean((2, 3, 4), keepdim=True)
        var = (yf * yf).mean((2, 3, 4), keepdim=True) - mean * mean
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS) * self.norm_weight.view(shape)
        out = ((yf - mean) * mul + self.norm_bias.view(shape)).to(self.dtype)
        return F.leaky_relu(out, self.slope)


class UNet3D(nn.Module):
    """Plan-configured 3D U-Net.

    forward(x: [N, C_in, D, H, W]) -> f32 logits [N, num_classes, D, H, W]
    at full resolution, or with ``deep_supervision=True`` the list of every
    level's logits, highest resolution first.

    ``fused_norm`` (default, inference): every block on K1's kernels.
    Training builds the model with it off. ``remat``: the blocks of stages
    0..``remat_max_stage`` keep no activations for the backward pass and
    are recomputed there (it applies only while autograd records). Neither
    flag changes the parameters."""

    def __init__(self, plan: Plan, dtype=torch.bfloat16, fused_norm: bool = True,
                 remat: bool = False, remat_max_stage: int = 1):
        super().__init__()
        self.plan = plan
        self.dtype = dtype
        self.remat = remat
        self.remat_max_stage = remat_max_stage
        feats = features_per_stage(plan)
        P = plan.num_pools
        pad = getattr(plan, "pad_style", "same")
        blocks = []
        self._stages = []  # the resolution stage of each block, for remat
        cin = int(plan.in_channels)

        def block(cin, cout, i, stride=(1, 1, 1)):
            self._stages.append(i)
            return ConvNormAct(cin, cout, plan.conv_kernels[i], stride, dtype, pad, fused_norm)

        for i in range(P + 1):
            stride = plan.pool_kernels[i - 1] if i > 0 else (1, 1, 1)
            blocks.append(block(cin, feats[i], i, stride))
            blocks.append(block(feats[i], feats[i], i))
            cin = feats[i]
        ups = []
        heads = [None] * max(P, 1)
        if P == 0:
            heads[0] = nn.Conv3d(cin, plan.num_classes, 1)
        for i in range(P - 1, -1, -1):
            pk = tuple(int(k) for k in plan.pool_kernels[i])
            ups.append(nn.ConvTranspose3d(cin, feats[i], pk, pk, bias=False))
            blocks.append(block(2 * feats[i], feats[i], i))
            blocks.append(block(feats[i], feats[i], i))
            heads[i] = nn.Conv3d(feats[i], plan.num_classes, 1)
            cin = feats[i]
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.heads = nn.ModuleList(heads)

    def _head(self, i, x):
        h = self.heads[i]
        y = F.conv3d(x, _weight(h.weight, self.dtype))
        return (y + h.bias.to(self.dtype).view(1, -1, 1, 1, 1)).float()

    def _blocks(self):
        """The blocks in call order, those to recompute wrapped in a
        checkpoint."""
        remat = self.remat and torch.is_grad_enabled()
        for blk, stage in zip(self.blocks, self._stages):
            if remat and stage <= self.remat_max_stage:
                yield lambda x, _b=blk: checkpoint(_b, x, use_reentrant=False)
            else:
                yield blk

    def forward(self, x, deep_supervision: bool = False):
        plan = self.plan
        P = plan.num_pools
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last_3d)
        blocks = self._blocks()
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


# the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2] (f32, CPU), by the
    inverse CDF of uniform draws between the two tails, as
    ``jax.random.truncated_normal`` draws them."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0).float()


def init_weights(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """Random weights from ``generator`` with flax's distributions: kernels
    LeCun-normal as ``nn.initializers.lecun_normal`` draws them (a normal
    truncated at 2 sigma, rescaled to std sqrt(1 / fan_in)), zero biases,
    unit norm scales."""
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
                std = math.sqrt(1.0 / fan_in) / TRUNC_STD
                p.copy_(truncated_normal(p.shape, generator) * std)
    return model
