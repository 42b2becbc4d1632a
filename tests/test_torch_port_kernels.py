"""K1 (instance-norm statistics) of deepwmh_tpu_torch against the JAX
package: the plain PyTorch version against the Pallas kernel in interpret
mode and against the model's XLA reduction. The CUDA kernel itself is held
against the plain version in tests/test_torch_port_cuda.py, on a card.

Tolerances: mean atol 1e-5, variance atol 1e-4 — f32 sums in different
orders over bf16 inputs (measured gap ~4e-6)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepwmh_tpu.ops.pallas_kernels import instance_norm_stats_pallas
from deepwmh_tpu.unet.model import _instance_norm_stats
from deepwmh_tpu_torch.ops import kernels

MEAN_ATOL = 1e-5
VAR_ATOL = 1e-4


def _input(shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2 + 0.5
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _check(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=MEAN_ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=VAR_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("c", [32, 64])
def test_plain_matches_pallas_interpret(n, c):
    # 6*6*7 = 252 voxels: m4 = 63 (C=32) / 126 (C=64) rows, a ragged last
    # block at block_rows=16
    xj, xt = _input((n, 6, 6, 7, c), seed=n * 100 + c)
    want = instance_norm_stats_pallas(xj, block_rows=16, interpret=True)
    _check(kernels.instance_norm_stats_reference(xt), want)


@pytest.mark.parametrize("c", [32, 64, 320])
def test_plain_matches_model_stats(c):
    xj, xt = _input((2, 5, 6, 7, c), seed=c)
    _check(kernels.instance_norm_stats_reference(xt), _instance_norm_stats(xj))


def test_wrapper_takes_plain_version_on_cpu():
    _, xt = _input((1, 4, 4, 4, 32))
    before = kernels.instance_norm_stats.launches
    got = kernels.instance_norm_stats(xt)
    want = kernels.instance_norm_stats_reference(xt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.instance_norm_stats.launches == before  # nothing launched



# ------------------------------------------------------------ the apply pass


def _chain_before_the_kernel(y, mean, var, weight, bias, dtype):
    """ConvNormAct's normalize + affine + leaky ReLU as the port ran it
    before the apply kernel, on the NCDHW conv output ``y``."""
    n, c = y.shape[:2]
    mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5) * weight
    bc = (n, c, 1, 1, 1)
    z = y.float().clone()
    z.sub_(mean.view(bc)).mul_(mul.view(bc)).add_(bias.view(1, c, 1, 1, 1))
    return torch.nn.functional.leaky_relu(z.to(dtype), float(torch.tensor(0.01, dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c", [(1, 32), (2, 64), (1, 8)])
def test_apply_reference_equals_the_chain_it_replaces(dtype, n, c):
    # bit for bit: the same f32 steps, each rounded on its own
    rng = np.random.RandomState(c + n)
    y = torch.from_numpy(rng.randn(n, c, 5, 6, 7).astype(np.float32) * 3).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last_3d)
    mean = torch.from_numpy(rng.randn(n, c).astype(np.float32))
    var = torch.from_numpy(rng.rand(n, c).astype(np.float32) * 4 - 0.1)  # a few < 0
    weight = torch.from_numpy(rng.randn(c).astype(np.float32))
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    want = _chain_before_the_kernel(y, mean, var, weight, bias, dtype)
    mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5) * weight
    x = y.permute(0, 2, 3, 4, 1)
    got = kernels.instance_norm_act_reference(x, mean, mul, bias, float(torch.tensor(0.01, dtype=dtype)))
    assert got.dtype == dtype
    assert torch.equal(got.permute(0, 4, 1, 2, 3), want)
    # a per-sample bias [N, C] broadcasts the same way
    got_nc = kernels.instance_norm_act_reference(
        x, mean, mul, bias.expand(n, c).contiguous(), float(torch.tensor(0.01, dtype=dtype)))
    assert torch.equal(got_nc, got)
    # the input is left as it was (f32 included)
    assert torch.equal(x.permute(0, 4, 1, 2, 3), y)


def test_apply_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(1, 4, 4, 4, 32).astype(np.float32)).to(torch.bfloat16)
    mean, mul = torch.zeros(1, 32), torch.ones(1, 32)
    bias = torch.from_numpy(rng.randn(32).astype(np.float32))
    before = kernels.instance_norm_act.launches
    got = kernels.instance_norm_act(x, mean, mul, bias, 0.01)
    assert torch.equal(got, kernels.instance_norm_act_reference(x, mean, mul, bias, 0.01))
    assert kernels.instance_norm_act.launches == before  # nothing launched
    assert "instance_norm_act" in kernels.KERNELS
