"""The plan-driven 3D U-Net in plain float32 PyTorch: the benchmark's
reference for the port's ``unet/model.py`` (no kernel, no remat, no cache).

Topology as the port runs it (and as nnU-Net's Generic U-Net is built):
two conv -> instance norm -> leaky ReLU blocks a stage, the first strided
past stage 0 with XLA SAME padding, transpose-conv upsampling with skip
concatenation, a 1x1x1 head at every decoder level. The module tree and
parameter names are the port's, so one state dict loads into both and
``init_weights`` draws the same values in the same order.

``precision`` selects how the convolutions compute: ``"f32"`` (the
reference; the caller turns TF32 off), ``"fp8"`` (the control: inputs
and kernels of every convolution rounded to float8 e4m3 with a per-tensor
scale, gradients passed straight through; normalisation stays float32) or
``"bf16"`` (a witness of what the configurations' stated bfloat16 does:
convolutions, their biases and the activations between blocks in
bfloat16, the norm's statistics and affine in float32, float32
parameters, as the port's plain chain computes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wmhbench.arith.unet import features_per_stage

LRELU_SLOPE = 0.01
NORM_EPS = 1e-5
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its absolute
    maximum onto 448), returned in float32; the gradient passes through."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - xd)


def _same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv3D(nn.Module):
    def __init__(self, cin, cout, kernel, stride=(1, 1, 1)):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(int(s) for s in stride)
        self.weight = nn.Parameter(torch.empty((cout, cin) + self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, rnd):
        pads = [_same_pads(int(x.shape[2 + a]), self.kernel[a], self.stride[a])
                for a in range(3)]
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        y = F.conv3d(F.pad(rnd(x), flat), rnd(self.weight), None, self.stride, 0)
        return y + self.bias.to(y.dtype).view(1, -1, 1, 1, 1)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, kernel, stride=(1, 1, 1)):
        super().__init__()
        self.conv = Conv3D(cin, cout, kernel, stride)
        self.norm_weight = nn.Parameter(torch.ones(cout))
        self.norm_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, rnd):
        y = self.conv(x, rnd)
        yf = y.float()
        mean = yf.mean((2, 3, 4), keepdim=True)
        var = (yf * yf).mean((2, 3, 4), keepdim=True) - mean * mean
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var.clamp_min(0.0) + NORM_EPS) * self.norm_weight.view(shape)
        out = ((yf - mean) * mul + self.norm_bias.view(shape)).to(y.dtype)
        # the slope as the activations' type holds it
        return F.leaky_relu(out, float(torch.tensor(LRELU_SLOPE, dtype=y.dtype)))


class UNet3D(nn.Module):
    """forward(x [N, 1, D, H, W]) -> f32 logits [N, C, D, H, W], or every
    level's logits (highest resolution first) with ``deep_supervision``."""

    def __init__(self, plan: dict, precision: str = "f32"):
        super().__init__()
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError("precision is f32, fp8 or bf16, not %r" % (precision,))
        self.rnd = {"fp8": fp8_round, "bf16": lambda t: t.to(torch.bfloat16),
                    "f32": lambda t: t}[precision]
        self.pools = [tuple(int(k) for k in pk) for pk in plan["pool_kernels"]]
        convs = plan["conv_kernels"]
        feats = features_per_stage(plan)
        P = len(self.pools)
        ncls = int(plan["num_classes"])
        blocks = []
        cin = int(plan["in_channels"])
        for i in range(P + 1):
            stride = self.pools[i - 1] if i > 0 else (1, 1, 1)
            blocks.append(ConvNormAct(cin, feats[i], convs[i], stride))
            blocks.append(ConvNormAct(feats[i], feats[i], convs[i]))
            cin = feats[i]
        ups, heads = [], [None] * P
        for i in range(P - 1, -1, -1):
            ups.append(nn.ConvTranspose3d(cin, feats[i], self.pools[i], self.pools[i],
                                          bias=False))
            blocks.append(ConvNormAct(2 * feats[i], feats[i], convs[i]))
            blocks.append(ConvNormAct(feats[i], feats[i], convs[i]))
            heads[i] = nn.Conv3d(feats[i], ncls, 1)
            cin = feats[i]
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.heads = nn.ModuleList(heads)

    def _head(self, i, x):
        h = self.heads[i]
        y = F.conv3d(self.rnd(x), self.rnd(h.weight))
        return (y + h.bias.to(y.dtype).view(1, -1, 1, 1, 1)).float()

    def forward(self, x, deep_supervision: bool = False):
        rnd = self.rnd
        P = len(self.pools)
        x = x.float()
        blocks = iter(self.blocks)
        skips = []
        for i in range(P + 1):
            x = next(blocks)(x, rnd)
            x = next(blocks)(x, rnd)
            if i < P:
                skips.append(x)
        outputs = []
        for u, i in enumerate(range(P - 1, -1, -1)):
            x = F.conv_transpose3d(rnd(x), rnd(self.ups[u].weight), stride=self.pools[i])
            x = torch.cat([x, skips[i]], dim=1)
            x = next(blocks)(x, rnd)
            x = next(blocks)(x, rnd)
            if deep_supervision or i == 0:
                outputs.append(self._head(i, x))
        outputs.reverse()
        return outputs if deep_supervision else outputs[0]


# the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """The port's ``unet/model.truncated_normal``: inverse-CDF draws of a
    standard normal truncated to [-2, 2] (f32, CPU)."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0).float()


def init_weights(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """The port's ``unet/model.init_weights`` (flax's LeCun-normal kernels,
    zero biases, unit norm scales), drawn in parameter order."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm_weight"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                cin = p.shape[0] if name.startswith("ups.") else p.shape[1]
                fan_in = int(cin) * math.prod(p.shape[2:])
                std = math.sqrt(1.0 / fan_in) / TRUNC_STD
                p.copy_(truncated_normal(p.shape, generator) * std)
    return model


def no_tf32():
    """Float32 convolutions and matmuls in float32, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
