"""deepwmh_tpu_torch UNet3D against the JAX UNet3D on the same weights and
inputs: f32 logits within atol 2e-4 / rtol 1e-3 (both pad styles, even and
odd shapes, every deep-supervision output), and the bf16 default within
argmax agreement > 0.98 (the tolerances of tests/test_torch_convert.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepwmh_tpu.unet.model import UNet3D as JUNet3D
from deepwmh_tpu.unet.plan import Plan as JPlan
from deepwmh_tpu_torch.ops import kernels
from deepwmh_tpu_torch.unet import model as tmodel
from deepwmh_tpu_torch.unet.checkpoint import params_from_flax
from deepwmh_tpu_torch.unet.plan import Plan

# pools [[2,2,2],[1,2,2]] need axis 0 even; [[1,2,2],[1,2,2]] leaves it free
PLANS = {
    "even": dict(pool_kernels=[[2, 2, 2], [1, 2, 2]],
                 conv_kernels=[[3, 3, 3], [3, 3, 3], [1, 3, 3]], shape=(10, 12, 20)),
    "odd": dict(pool_kernels=[[1, 2, 2], [1, 2, 2]],
                conv_kernels=[[1, 3, 3], [3, 3, 3], [3, 3, 3]], shape=(7, 12, 8)),
}


def _plans(kind, pad_style):
    cfg = dict(PLANS[kind])
    shape = cfg.pop("shape")
    kw = dict(target_spacing=[1.0] * 3, patch_size=[16] * 3, batch_size=2,
              base_features=4, max_features=8, pad_style=pad_style, **cfg)
    return JPlan(**kw), Plan(**kw), shape


def _params(jplan, shape, seed=0):
    """JAX init plus noise, so norm scales/biases and head biases are not
    their trivial init values."""
    x = jnp.zeros((1,) + shape + (1,), jnp.bfloat16)
    params = jax.jit(JUNet3D(plan=jplan).init)(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)


def _jax_apply(model, params, x, deep_supervision=False):
    fn = jax.jit(lambda p, v: model.apply({"params": p}, v, deep_supervision=deep_supervision))
    return fn(params, jnp.asarray(x[..., None]))


def _port(plan, params, dtype):
    m = tmodel.UNet3D(plan, dtype=dtype)
    m.load_state_dict(params_from_flax(params))
    return m.eval()


@pytest.mark.parametrize("kind", ["even", "odd"])
@pytest.mark.parametrize("pad_style", ["same", "torch"])
def test_f32_logits_match_jax(kind, pad_style):
    jplan, plan, shape = _plans(kind, pad_style)
    params = _params(jplan, shape)
    x = np.random.RandomState(1).randn(2, *shape).astype(np.float32)
    want = _jax_apply(JUNet3D(plan=jplan, dtype=jnp.float32), params, x, True)
    with torch.no_grad():
        got = _port(plan, params, torch.float32)(torch.from_numpy(x[:, None]),
                                                 deep_supervision=True)
    assert len(got) == len(want) == jplan.num_pools
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).numpy(), np.asarray(w),
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", ["even", "odd"])
def test_bf16_argmax_matches_jax(kind):
    jplan, plan, shape = _plans(kind, "same")
    params = _params(jplan, shape, seed=3)
    x = np.random.RandomState(4).randn(1, *shape).astype(np.float32)
    want = np.asarray(_jax_apply(JUNet3D(plan=jplan), params, x))
    with torch.no_grad():
        got = _port(plan, params, torch.bfloat16)(torch.from_numpy(x[:, None]))
    assert got.dtype == torch.float32
    agree = float(np.mean(got.permute(0, 2, 3, 4, 1).numpy().argmax(-1) == want.argmax(-1)))
    assert agree > 0.98, agree


def test_k1_reads_activations_in_place(monkeypatch):
    """Every ConvNormAct hands K1 a contiguous [N, D, H, W, C] view of its
    channels-last activation — what the CUDA kernel requires, with no copy."""
    jplan, plan, shape = _plans("even", "same")
    seen = []
    stats = kernels.instance_norm_stats

    def record(x):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return stats(x)

    # instance_norm_act_fn's forward looks K1 up in ops.kernels
    monkeypatch.setattr(kernels, "instance_norm_stats", record)
    m = tmodel.init_weights(tmodel.UNet3D(plan), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        m(torch.randn(1, 1, *shape))
    assert len(seen) == 4 * plan.num_pools + 2
    assert all(contiguous for _, contiguous in seen), seen


def test_init_weights_is_seeded():
    _, plan, _ = _plans("even", "same")
    a = tmodel.init_weights(tmodel.UNet3D(plan), torch.Generator().manual_seed(5))
    b = tmodel.init_weights(tmodel.UNet3D(plan), torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
        assert torch.isfinite(va).all()


# ------------------------------------------------------------ one ConvNormAct


def _conv_norm_act_pair(cin, cout, dtype_j, dtype_t, fused, seed):
    """flax's ConvNormAct and the port's on the same (noisy) parameters."""
    from deepwmh_tpu.unet.model import ConvNormAct as JConvNormAct
    from deepwmh_tpu_torch.unet.checkpoint import _conv_to_torch

    jblock = JConvNormAct(features=cout, kernel=(3, 3, 3), dtype=dtype_j, fused_stats=fused)
    x0 = jnp.zeros((1, 6, 6, 8, cin), dtype_j)
    params = jblock.init(jax.random.PRNGKey(seed), x0)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    tblock = tmodel.ConvNormAct(cin, cout, (3, 3, 3), dtype=dtype_t)
    with torch.no_grad():
        tblock.conv.weight.copy_(torch.from_numpy(_conv_to_torch(params["Conv_0"]["kernel"])))
        tblock.conv.bias.copy_(torch.from_numpy(params["Conv_0"]["bias"]))
        tblock.norm_weight.copy_(torch.from_numpy(params["GroupNorm_0"]["scale"]))
        tblock.norm_bias.copy_(torch.from_numpy(params["GroupNorm_0"]["bias"]))
    return jblock, params, tblock.eval()


def _pallas_stats(monkeypatch):
    """Send the flax fused path's statistics through the Pallas kernel in
    interpret mode (on the CPU it would take the XLA reduction)."""
    from deepwmh_tpu.ops.pallas_kernels import instance_norm_stats_pallas
    from deepwmh_tpu.unet import model as jmodel

    monkeypatch.setattr(jmodel, "_instance_norm_stats",
                        lambda x: instance_norm_stats_pallas(x, block_rows=16, interpret=True))


@pytest.mark.parametrize("fused", [True, False])
def test_conv_norm_act_f32_matches_flax(monkeypatch, fused):
    # f32 atol 2e-4 / rtol 1e-3 (tests/test_torch_convert.py): the convs'
    # and the statistics' sums in other orders
    if fused:
        _pallas_stats(monkeypatch)
    jblock, params, tblock = _conv_norm_act_pair(4, 32, jnp.float32, torch.float32, fused, 0)
    x = np.random.RandomState(1).randn(2, 6, 6, 8, 4).astype(np.float32)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).permute(0, 4, 1, 2, 3)
                     .contiguous(memory_format=torch.channels_last_3d))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_conv_norm_act_bf16_argmax_matches_flax(monkeypatch, fused):
    # bf16: channel argmax agreement > 0.98 (tests/test_torch_convert.py)
    if fused:
        _pallas_stats(monkeypatch)
    jblock, params, tblock = _conv_norm_act_pair(8, 32, jnp.bfloat16, torch.bfloat16, fused, 2)
    x = np.random.RandomState(3).randn(1, 6, 6, 8, 8).astype(np.float32)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).permute(0, 4, 1, 2, 3)
                     .contiguous(memory_format=torch.channels_last_3d))
    assert got.dtype == torch.bfloat16
    agree = float(np.mean(got.float().permute(0, 2, 3, 4, 1).numpy().argmax(-1) == want.argmax(-1)))
    assert agree > 0.98, agree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_norm_act_cpu_bits_unchanged(dtype):
    """On the CPU the block gives the bits of the chain it ran before the
    apply pass became a kernel: conv, K1's plain statistics, then f32
    subtract, multiply, add in place, cast, leaky ReLU."""
    torch.manual_seed(0)
    block = tmodel.ConvNormAct(8, 16, (3, 3, 3), dtype=dtype).eval()
    with torch.no_grad():
        block.conv.weight.normal_()
        block.norm_weight.uniform_(0.5, 1.5)
        block.norm_bias.normal_()
        x = torch.randn(2, 8, 5, 6, 7).contiguous(memory_format=torch.channels_last_3d)
        got = block(x)
        y = block.conv(x)
        mean, var = kernels.instance_norm_stats_reference(y.permute(0, 2, 3, 4, 1))
        mul = torch.rsqrt(var.clamp_min(0.0) + tmodel.NORM_EPS) * block.norm_weight
        bc = (2, 16, 1, 1, 1)
        z = y.float()
        z.sub_(mean.view(bc)).mul_(mul.view(bc)).add_(block.norm_bias.view(1, 16, 1, 1, 1))
        want = torch.nn.functional.leaky_relu(z.to(dtype), tmodel._leaky_slope(dtype))
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)


def test_apply_pass_reads_activations_in_place(monkeypatch):
    """Every ConvNormAct hands the apply pass the same contiguous
    [N, D, H, W, C] view it hands K1, with its [N, C] statistics."""
    jplan, plan, shape = _plans("even", "same")
    seen = []
    apply = kernels.instance_norm_act

    def record(x, mean, mul, bias, slope):
        seen.append((tuple(x.shape), x.is_contiguous(), tuple(mean.shape), tuple(mul.shape),
                     tuple(bias.shape)))
        return apply(x, mean, mul, bias, slope)

    monkeypatch.setattr(kernels, "instance_norm_act", record)
    m = tmodel.init_weights(tmodel.UNet3D(plan), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        m(torch.randn(1, 1, *shape))
    assert len(seen) == 4 * plan.num_pools + 2
    for xs, contiguous, ms, ws, bs in seen:
        assert contiguous and ms == ws == (xs[0], xs[-1]) and bs == (xs[-1],)
