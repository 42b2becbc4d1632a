"""deepwmh_tpu_torch on a CUDA card: each hand-written kernel against its
plain PyTorch version (the apply pass and K2 bit for bit, K1 within 1e-4
and with the same bits on every call), the wrappers' checks, and the U-Net
and the 3 mm median on the card against the CPU. Every test here needs a card and skips without one; this
file imports no JAX, so that it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from deepwmh_tpu_torch.ops import filters, kernels
from deepwmh_tpu_torch.unet.model import UNet3D, init_weights
from deepwmh_tpu_torch.unet.plan import Plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", [
    ((1, 16, 20, 12, 32), torch.bfloat16),
    ((2, 6, 7, 6, 320), torch.bfloat16),
    ((8, 5, 5, 5, 64), torch.bfloat16),
    ((2, 10, 12, 9, 8), torch.float32),
    ((1, 3, 1, 1, 16), torch.bfloat16),
])
def test_instance_norm_stats_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    before = kernels.instance_norm_stats.launches
    mean, var = kernels.instance_norm_stats(x)
    torch.cuda.synchronize()
    assert kernels.instance_norm_stats.launches == before + 1
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (shape[0], shape[-1])
    ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
    # f32 sums in another order than torch's reduction
    torch.testing.assert_close(mean, ref_mean, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(var, ref_var, atol=1e-4, rtol=1e-4)


def test_instance_norm_stats_refuses_what_it_cannot_read(cuda):
    x = torch.randn(1, 4, 4, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.instance_norm_stats(x.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        kernels.instance_norm_stats(x.half())
    with pytest.raises(ValueError, match="C % 8"):
        kernels.instance_norm_stats(x[..., :4].contiguous())


def _flagship_stats_shapes():
    """[1, *spatial, C] of every K1 call of a flagship 192x224x192 forward."""
    from chip_smoke import stats_shapes
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso

    return [(1,) + spatial + (c,) for spatial, c, _ in
            stats_shapes(default_plan_1mm_iso(), (192, 224, 192))]


def test_instance_norm_stats_deep_shapes_repeat_bits(cuda):
    """At the flagship's deeper shapes (one block of partials or a few), two
    calls give the same bits (a fixed order of additions, whichever block
    finishes last) and agree with the plain version within 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for shape in _flagship_stats_shapes()[1:]:
        x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(torch.bfloat16)
        first = kernels.instance_norm_stats(x)
        second = kernels.instance_norm_stats(x)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]), shape
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.testing.assert_close(first[0], ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(first[1], ref_var, atol=1e-4, rtol=1e-4)


def _apply_inputs(shape, dtype, device, seed, per_sample_bias=False):
    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=g, device=device) * 3 + 0.25).to(dtype)
    mean = torch.randn((n, c), generator=g, device=device) * 0.5
    mul = torch.rand((n, c), generator=g, device=device) * 2 + 0.1
    bias = torch.randn((n, c) if per_sample_bias else (c,), generator=g, device=device)
    return x, mean, mul, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [32, 64, 128, 256, 320])
def test_instance_norm_act_equals_plain(cuda, dtype, c):
    """The apply kernel has the plain chain's bits at every flagship width,
    with a ragged row count (5*7*9 = 315) and two samples."""
    slope = float(torch.tensor(0.01, dtype=dtype))
    for per_sample_bias in (False, True):
        x, mean, mul, bias = _apply_inputs((2, 5, 7, 9, c), dtype, cuda, c, per_sample_bias)
        before = kernels.instance_norm_act.launches
        got = kernels.instance_norm_act(x, mean, mul, bias, slope)
        torch.cuda.synchronize()
        assert kernels.instance_norm_act.launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
        assert torch.equal(got, kernels.instance_norm_act_reference(x, mean, mul, bias, slope))


def test_instance_norm_act_equals_plain_at_full_resolution(cuda):
    x, mean, mul, bias = _apply_inputs(_flagship_stats_shapes()[0], torch.bfloat16, cuda, 3)
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))
    got = kernels.instance_norm_act(x, mean, mul, bias, slope)
    assert torch.equal(got, kernels.instance_norm_act_reference(x, mean, mul, bias, slope))


def test_instance_norm_act_refuses_what_it_cannot_read(cuda):
    x, mean, mul, bias = _apply_inputs((1, 4, 4, 4, 32), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.instance_norm_act(x.transpose(1, 2), mean, mul, bias, 0.01)
    with pytest.raises(ValueError, match="mean"):
        kernels.instance_norm_act(x, mean[:, :16], mul, bias, 0.01)
    with pytest.raises(ValueError, match="mul"):
        kernels.instance_norm_act(x, mean, mul.double(), bias, 0.01)
    with pytest.raises(ValueError, match="bias"):
        kernels.instance_norm_act(x, mean, mul, bias.cpu(), 0.01)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.instance_norm_act(x, mean, mul, bias.requires_grad_(), 0.01)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.instance_norm_stats(x.float().requires_grad_())


def test_unet_on_card_matches_cpu(cuda):
    """f32 with TF32 off: the kernel path on the card against the plain path
    on the CPU; every block's statistics come from one kernel launch and its
    normalize + leaky ReLU from one more."""
    plan = Plan(target_spacing=[1.0] * 3, patch_size=[16] * 3, batch_size=2,
                pool_kernels=[[2, 2, 2], [1, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
                base_features=8, max_features=16)
    model = init_weights(UNet3D(plan, dtype=torch.float32), torch.Generator().manual_seed(0)).eval()
    x = torch.randn((2, 1, 12, 16, 20), generator=torch.Generator().manual_seed(1))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(x, deep_supervision=True)
            card = model.to(cuda, memory_format=torch.channels_last_3d)
            before = kernels.instance_norm_stats.launches
            before_act = kernels.instance_norm_act.launches
            got = card(x.to(cuda), deep_supervision=True)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert kernels.instance_norm_stats.launches - before == 4 * plan.num_pools + 2
    assert kernels.instance_norm_act.launches - before_act == 4 * plan.num_pools + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


def _signed_volume(shape, seed, device):
    """Negative values, +0.0 and -0.0, as stage-1's masked anomaly has."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(shape, generator=g)
    v[torch.rand(shape, generator=g) < 0.3] = 0.0
    v[torch.rand(shape, generator=g) < 0.15] = -0.0
    return v.to(device)


@pytest.mark.parametrize("shape", [(61, 67, 53), (1, 1, 1), (2, 9, 33), (5, 1, 70), (17, 8, 32),
                                   (192, 224, 192), (33, 9, 65)])
def test_median3_matches_plain(cuda, shape):
    vol = _signed_volume(shape, sum(shape), cuda)
    before = kernels.median3.launches
    got = kernels.median3(vol)
    torch.cuda.synchronize()
    assert kernels.median3.launches == before + 1
    assert got.shape == vol.shape and got.dtype == torch.float32
    # a median is a selection: value equality (-0.0 == +0.0)
    assert torch.equal(got, kernels.median3_reference(vol))
    assert torch.equal(got.cpu(), kernels.median3_reference(vol.cpu()))


def test_median3_refuses_what_it_cannot_read(cuda):
    vol = torch.randn(6, 7, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.median3(vol.transpose(0, 2))
    with pytest.raises(ValueError, match="f32"):
        kernels.median3(vol.double())
    with pytest.raises(ValueError, match="f32"):
        kernels.median3(vol[0])


@pytest.mark.parametrize("voxel_size", [(2.0, 2.0, 2.0), (1.0, 1.0, 5.0)])
def test_median_3mm_on_card_equals_cpu(cuda, voxel_size):
    vol = _signed_volume((24, 30, 22), 7, "cpu")
    before = kernels.median3.launches
    got = filters.median_3mm(vol.to(cuda), voxel_size)
    torch.cuda.synchronize()
    # (3, 3, 3) at 2 mm goes to K2; 1x1x5 mm is a (3, 3, 1) sort on both
    assert kernels.median3.launches - before == (1 if voxel_size[2] == 2.0 else 0)
    assert torch.equal(got.cpu(), filters.median_3mm(vol, voxel_size))
