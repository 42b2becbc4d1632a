"""deepwmh_tpu_torch on a CUDA card: each hand-written kernel against its
plain PyTorch version, the wrappers' checks, and the U-Net on the card
against the CPU. Every test here needs a card and skips without one; this
file imports no JAX, so that it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from deepwmh_tpu_torch.ops import kernels
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


def test_unet_on_card_matches_cpu(cuda):
    """f32 with TF32 off: the kernel path on the card against the plain path
    on the CPU; every block's statistics come from one kernel launch."""
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
            got = card(x.to(cuda), deep_supervision=True)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert kernels.instance_norm_stats.launches - before == 4 * plan.num_pools + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
