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

    def record(x):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return kernels.instance_norm_stats(x)

    monkeypatch.setattr(tmodel, "instance_norm_stats", record)
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
