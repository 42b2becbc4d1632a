"""deepwmh_tpu_torch on a CUDA card: each hand-written kernel against its
plain PyTorch version (the apply pass and K2 bit for bit, K1 within 1e-4
and with the same bits on every call), the wrappers' checks, the U-Net
and the 3 mm median on the card against the CPU, K1's backward kernels
against their plain versions (the flagship train shapes and the narrow
widths; the same bits twice), the model on K1 under autograd and the
trainer's step launching K1 forward and backward a block (remat's
recompute counted; remat on and off the same gradients), a warm train step
on a batch from the loop's upload path with no synchronising transfer, the
side-stream augmentation draws bit for bit against ``draw_augment``'s on the
compute stream, the serving burst
against one-case runs, K1 at the learned registration network's shapes
(C = 8, 16, 32), registration's field gather on the card against the
CPU, a tiny ``run_train`` on the card launching K1 and K2, the DICOM
import's native host library built on the card's machine and equal to its
Python versions, its host labelling equal to the card's at the flagship
size, an 8-shard mesh on one card (the halo-sharded median
and the flip-sharded sweep bit for bit against the unsharded ones) and a
2-shard one (a data-parallel step leaving both replicas the same bits,
``register_pairs_mesh``'s blocks bit for bit against one batch each), K2
over a batch of volumes in one launch, and a batch of pairs against one
pair at a time. Every test here needs a card and skips without one; this
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
    """Narrow widths that divide 16 bytes (C = 4 in bf16) are read since
    fault B0; other dtypes, rank < 3, widths neither a multiple nor a divisor
    of 16 bytes' worth and widths past 1024 threads a block still raise, and
    so do blocks past the statistics kernel's launch bounds (256 threads:
    C > 2048 in bf16)."""
    x = torch.randn(1, 4, 4, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.instance_norm_stats(x.transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        kernels.instance_norm_stats(x.half())
    with pytest.raises(ValueError, match="C % 8"):
        kernels.instance_norm_stats(x[..., :3].contiguous())
    with pytest.raises(ValueError, match="C % 4"):
        kernels.instance_norm_stats(x[..., :6].float().contiguous())
    with pytest.raises(ValueError, match=r"\[N, \*spatial, C\]"):
        kernels.instance_norm_stats(x.reshape(-1, 32))
    with pytest.raises(ValueError, match="too wide"):
        kernels.instance_norm_stats(torch.zeros(1, 2, 8 * 1025, device=cuda,
                                                dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cannot launch"):
        kernels.instance_norm_stats(torch.zeros(1, 2, 8 * 257, device=cuda,
                                                dtype=torch.bfloat16))
    kernels.instance_norm_stats(x[..., :4].contiguous())
    torch.cuda.synchronize()


# (shape, dtype) at K1's narrow widths: C = 1, 2, 4 in bf16 and 1, 2 in f32,
# with M * C a multiple of 16 bytes' worth and not (a tail read element by
# element; with N > 1 later samples also start off a 16-byte boundary)
NARROW_K1 = [
    ((1, 16, 20, 12, 4), torch.bfloat16),
    ((2, 7, 9, 5, 4), torch.bfloat16),
    ((3, 5, 5, 3, 2), torch.bfloat16),
    ((2, 33, 17, 9, 1), torch.bfloat16),
    ((1, 64, 80, 64, 4), torch.bfloat16),
    ((2, 10, 12, 9, 2), torch.float32),
    ((3, 5, 7, 3, 1), torch.float32),
    ((1, 1, 1, 1, 1), torch.float32),
    ((2, 64, 80, 64, 2), torch.float32),
]


@pytest.mark.parametrize("shape,dtype", NARROW_K1)
def test_instance_norm_stats_narrow_widths(cuda, shape, dtype):
    """Fault B0: K1's statistics at the narrow widths JAX's kernel takes
    (128 % C == 0), one launch each, within K1's tolerance of the plain
    version and the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    before = kernels.instance_norm_stats.launches
    first = kernels.instance_norm_stats(x)
    second = kernels.instance_norm_stats(x)
    torch.cuda.synchronize()
    assert kernels.instance_norm_stats.launches == before + 2
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
    torch.testing.assert_close(first[0], ref_mean, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(first[1], ref_var, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,dtype", NARROW_K1)
def test_instance_norm_act_narrow_widths_equal_plain(cuda, shape, dtype):
    """Fault B0: the apply pass at the narrow widths, bit for bit the plain
    chain, with per-sample and shared bias."""
    for per_sample in (False, True):
        x, mean, mul, bias = _apply_inputs(shape, dtype, cuda, 5, per_sample_bias=per_sample)
        got = kernels.instance_norm_act(x, mean, mul, bias, 0.01)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.instance_norm_act_reference(x, mean, mul, bias, 0.01))


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
    """The stats kernel's layout rules (narrow widths read since fault B0),
    then the statistics' own checks and autograd."""
    x, mean, mul, bias = _apply_inputs((1, 4, 4, 4, 32), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.instance_norm_act(x.transpose(1, 2), mean, mul, bias, 0.01)
    with pytest.raises(ValueError, match="dtype"):
        kernels.instance_norm_act(x.half(), mean, mul, bias, 0.01)
    x3, mean3, mul3, bias3 = _apply_inputs((1, 4, 4, 4, 3), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="C % 8"):
        kernels.instance_norm_act(x3, mean3, mul3, bias3, 0.01)
    x4, mean4, mul4, bias4 = _apply_inputs((1, 4, 4, 4, 4), torch.bfloat16, cuda, 0)
    kernels.instance_norm_act(x4, mean4, mul4, bias4, 0.01)
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


@pytest.mark.parametrize("B", [1, 2, 3])
def test_median3_batch_is_one_launch_bit_equal(cuda, B):
    """K2 over [B, D, H, W] (D = 37, not a multiple of the 16-plane depth
    chunk; H, W odd): one launch, each volume equal to its own call and to
    the plain version. The volumes differ by large constants, so a chunk
    reading the next volume's first plane as plane D would show."""
    shape = (B, 37, 21, 45)
    vols = _signed_volume(shape, B, cuda) + 1000.0 * torch.arange(B, device=cuda).view(B, 1, 1, 1)
    before = kernels.median3.launches
    got = kernels.median3(vols)
    torch.cuda.synchronize()
    assert kernels.median3.launches == before + 1
    assert got.shape == vols.shape
    for b in range(B):
        assert torch.equal(got[b], kernels.median3(vols[b].contiguous()))
    assert torch.equal(got, kernels.median3_reference(vols))


@pytest.mark.parametrize("voxel_size", [(2.0, 2.0, 2.0), (1.0, 1.0, 5.0)])
def test_median_3mm_on_card_equals_cpu(cuda, voxel_size):
    vol = _signed_volume((24, 30, 22), 7, "cpu")
    before = kernels.median3.launches
    got = filters.median_3mm(vol.to(cuda), voxel_size)
    torch.cuda.synchronize()
    # (3, 3, 3) at 2 mm goes to K2; 1x1x5 mm is a (3, 3, 1) sort on both
    assert kernels.median3.launches - before == (1 if voxel_size[2] == 2.0 else 0)
    assert torch.equal(got.cpu(), filters.median_3mm(vol, voxel_size))


def _tiny_plan():
    return Plan(target_spacing=[2.0] * 3, patch_size=[16] * 3, batch_size=2,
                pool_kernels=[[2, 2, 2], [2, 2, 2]], conv_kernels=[[3, 3, 3]] * 3,
                base_features=16, max_features=32)


def _k1_launches(fn):
    """fn() and each of K1's four kernels' launches during it."""
    names = ("instance_norm_stats", "instance_norm_act", "instance_norm_act_bwd_stats",
             "instance_norm_act_bwd_dx")
    before = {n: kernels.KERNELS[n].launches for n in names}
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(kernels.KERNELS[n].launches - before[n] for n in names)


def _remat_blocks(plan, max_stage=1):
    """The blocks of stages 0..max_stage, which remat runs twice."""
    return sum(2 if i == plan.num_pools else 4 for i in range(min(max_stage, plan.num_pools) + 1))


def test_fused_model_refuses_autograd(cuda):
    """A model on K1 (fused_norm, the default) trains on the card since K1
    has a backward: under autograd each block launches K1's two forward
    kernels once and K1's two backward kernels once (remat off), and remat
    adds one forward a block of stages 0-1; a finite loss and gradient.
    (The name predates K1's backward; the test keeps it.)"""
    plan = _tiny_plan()
    blocks = 4 * plan.num_pools + 2
    for remat, forwards in ((False, blocks), (True, blocks + _remat_blocks(plan))):
        model = init_weights(UNet3D(plan, remat=remat), torch.Generator().manual_seed(0))
        model = model.to(cuda, memory_format=torch.channels_last_3d)
        x = torch.randn(2, 1, 16, 16, 16, device=cuda)

        def step():
            loss = model(x).float().square().mean()
            return loss, torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)

        (loss, grads), launched = _k1_launches(step)
        assert launched == (forwards, forwards, blocks, blocks), (remat, launched)
        assert torch.isfinite(loss)
        assert all(torch.isfinite(g).all() for g in grads if g is not None)


def test_training_model_launches_no_k1(cuda, tmp_path):
    """A Trainer step (augmentation on) on the card runs K1: on the tiny
    plan 18 launches of each forward kernel (10 blocks and remat's 8) and
    10 of each backward kernel; at the flagship plan (patch 128x160x128,
    batch 2) 30 and 22. A finite loss each. (The name predates K1's
    backward; the test keeps it.)"""
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    for plan, (forwards, backwards) in ((_tiny_plan(), (18, 10)),
                                        (default_plan_1mm_iso(), (30, 22))):
        blocks = 4 * plan.num_pools + 2
        assert (forwards, backwards) == (blocks + _remat_blocks(plan), blocks)
        tr = Trainer(plan, TrainConfig(epochs=1, batches_per_epoch=2), str(tmp_path),
                     device=cuda)
        tr.init_state(0)
        g = torch.Generator().manual_seed(1)
        images = torch.randn((2,) + tuple(plan.patch_size), generator=g).to(cuda)
        labels = (images > 1.0).long()
        gen = torch.Generator(device=cuda).manual_seed(2)
        loss, launched = _k1_launches(lambda: tr.train_step(images, labels, tr.lr_at(0), gen))
        assert torch.isfinite(loss)
        assert launched == (forwards, forwards, backwards, backwards), (plan, launched)
        del tr


def test_warm_train_step_waits_on_no_stream(cuda, tmp_path):
    """After two warm steps, a third ``Trainer.train_step`` on a batch from
    the loop's upload path (pinned memory, the copy stream, its event
    ordering the batch on the compute stream) runs under
    ``set_sync_debug_mode("error")`` and raises nothing: no transfer of the
    step waits on a stream. Every augmentation branch is on, the spatial
    warp's matrix and centre among them."""
    import numpy as np

    from deepwmh_tpu_torch.unet.augment import AugmentConfig
    from deepwmh_tpu_torch.unet.data import SegDataset
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    plan = _tiny_plan()
    every = AugmentConfig(p_rotscale=1.0, p_noise=1.0, p_brightness=1.0, p_contrast=1.0,
                          p_gamma=1.0, p_mirror=1.0)
    tr = Trainer(plan, TrainConfig(epochs=1, batches_per_epoch=3, aug=every), str(tmp_path),
                 device=cuda)
    tr.init_state(0)
    rng = np.random.RandomState(0)
    ds = SegDataset(plan.patch_size)
    for i in range(2):
        ds.add_case("c%d" % i, rng.randn(20, 24, 18).astype(np.float32),
                    (rng.rand(20, 24, 18) > 0.9).astype(np.uint8))
    gen = torch.Generator(device=cuda).manual_seed(2**31 + 7)

    def batch():
        return tr._take(*tr._upload(*ds.sample_batch(rng, 2, 0.33)))

    losses = [tr.train_step(*batch(), tr.lr_at(k), gen) for k in range(2)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        images, labels = batch()
        assert images.dtype == torch.float32 and labels.dtype == torch.int32
        losses.append(tr.train_step(images, labels, tr.lr_at(2), gen))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(loss) for loss in losses)


@pytest.mark.parametrize("shape", [(16, 16, 16), (128, 160, 128)])
def test_side_stream_draws_are_draw_augments(cuda, shape):
    """Two samples' draws on the draw stream (``draw_samples`` on a card)
    equal ``draw_augment``'s on the compute stream from the same generator
    state, scalars and noise fields bit for bit, and the generator ends in
    the same state."""
    import dataclasses

    from deepwmh_tpu_torch.unet import augment

    cfg = augment.AugmentConfig()
    gen = torch.Generator(device=cuda).manual_seed(2**31 + 11)
    start = gen.get_state()
    got = augment.draw_samples(gen, shape, 2, cfg)
    end = gen.get_state()
    gen.set_state(start)
    want = [augment.draw_augment(gen, shape, cfg) for _ in range(2)]
    assert torch.equal(gen.get_state(), end)
    for g, w in zip(got, want):
        assert g.noise.device == w.noise.device and torch.equal(g.noise, w.noise)
        assert dataclasses.replace(g, noise=None) == dataclasses.replace(w, noise=None)


def _flagship_train_shapes():
    """[2, *spatial, C] of every K1 call of a flagship train step (patch
    128x160x128, batch 2)."""
    from chip_smoke import stats_shapes
    from deepwmh_tpu_torch.unet.plan import default_plan_1mm_iso

    plan = default_plan_1mm_iso()
    return [(2,) + spatial + (c,)
            for spatial, c, _ in stats_shapes(plan, tuple(plan.patch_size))]


def _backward_inputs(shape, dtype, device, seed, per_sample_bias=False):
    """x, dy and the forward's statistics of ``x`` as K1 computes them,
    with a unit-ish scale and a bias that sends part of the pre-activations
    below 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    weight = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.randn((n, c) if per_sample_bias else (c,), generator=g, device=device) - 0.3
    mean, var = kernels.instance_norm_stats(x)
    return x, dy, mean, var, weight, bias


def _check_backward(x, dy, mean, var, weight, bias, slope):
    """The backward's two kernels against their plain versions: the first
    pass's terms the same bits on a second call and within 1e-5 of the
    plain version's, relative to the same terms over |g| and |g * (x -
    mean)| (f32 sums in another order than torch's reduction); dx from the
    kernel's own terms bit for bit the plain dx pass; the whole backward
    within one ulp of x's dtype of the plain one."""
    mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5) * weight
    got = kernels.instance_norm_act_bwd_stats(x, dy, mean, mul, bias, var, slope, 1e-5)
    again = kernels.instance_norm_act_bwd_stats(x, dy, mean, mul, bias, var, slope, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = kernels.instance_norm_act_bwd_stats_reference(x, dy, mean, mul, bias, var, slope,
                                                         1e-5)
    g, xc = kernels._backward_g(x, dy, mean, mul, bias, slope)
    axes = tuple(range(1, x.dim() - 1))
    m = x.numel() // (x.shape[0] * x.shape[-1])
    rstd = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    # each term over |g| and |g * (x - mean)|: the size of its sum
    abs_g, abs_gx = g.abs().sum(axes), (g * xc).abs().sum(axes) * rstd
    del g, xc
    sizes = (abs_g / m, abs_gx * rstd / m, abs_gx.sum(0), abs_g.sum(0))
    for a, b, size in zip(got, want, sizes):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert bool(((a - b).abs() <= 1e-5 * size + 1e-30).all())
    k1, k2 = got[0], got[1]
    dx = kernels.instance_norm_act_bwd_dx(x, dy, mean, mul, bias, k1, k2, slope)
    assert dx.dtype == x.dtype and dx.shape == x.shape and dx.is_contiguous()
    assert torch.equal(dx, kernels.instance_norm_act_bwd_dx_reference(x, dy, mean, mul, bias,
                                                                     k1, k2, slope))
    got = kernels.instance_norm_act_backward(x, dy, mean, var, mul, bias, slope, 1e-5)
    want = kernels.instance_norm_act_backward_reference(x, dy, mean, var, mul, bias, slope,
                                                        1e-5)
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -20
    scale = float(want[0].float().abs().max())
    assert bool(((got[0].float() - want[0].float()).abs()
                 <= ulp * want[0].float().abs() + 1e-3 * scale).all())
    for a, b, size in zip(got[1:], want[1:], sizes[2:]):
        assert bool(((a - b).abs() <= 1e-5 * size + 1e-30).all())


@pytest.mark.parametrize("i", range(6))
def test_instance_norm_act_backward_at_flagship_train_shapes(cuda, i):
    """K1's backward at each [2, M, C] of a flagship train step (bf16, the
    bf16 model's slope), checked by _check_backward."""
    shape = _flagship_train_shapes()[i]
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))
    _check_backward(*_backward_inputs(shape, torch.bfloat16, cuda, i), slope)


@pytest.mark.parametrize("shape,dtype", NARROW_K1)
def test_instance_norm_act_backward_narrow_widths(cuda, shape, dtype):
    """K1's backward at K1's narrow widths (C = 1, 2, 4 bf16; 1, 2 f32),
    heads and tails read element by element, per-sample and shared bias."""
    for per_sample in (False, True):
        _check_backward(*_backward_inputs(shape, dtype, cuda, 7, per_sample), 0.01)


def test_instance_norm_act_backward_refuses_what_it_cannot_read(cuda):
    x, dy, mean, var, weight, bias = _backward_inputs((1, 4, 4, 4, 32), torch.bfloat16, cuda, 0)
    mul = torch.rsqrt(var.clamp_min(0.0) + 1e-5) * weight
    with pytest.raises(ValueError, match="dy must match"):
        kernels.instance_norm_act_bwd_stats(x, dy.float(), mean, mul, bias, var, 0.01, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.instance_norm_act_bwd_stats(x, dy.transpose(1, 2), mean, mul, bias, var, 0.01,
                                            1e-5)
    with pytest.raises(ValueError, match="var"):
        kernels.instance_norm_act_bwd_stats(x, dy, mean, mul, bias, var[:, :16], 0.01, 1e-5)
    with pytest.raises(ValueError, match="k2"):
        kernels.instance_norm_act_bwd_dx(x, dy, mean, mul, bias, mean, mul.double(), 0.01)
    with pytest.raises(ValueError, match="C % 8"):
        kernels.instance_norm_act_bwd_dx(x[..., :3].contiguous(), dy[..., :3].contiguous(),
                                         mean[:, :3].contiguous(), mul[:, :3].contiguous(),
                                         bias[:3].contiguous(), mean[:, :3].contiguous(),
                                         mean[:, :3].contiguous(), 0.01)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.instance_norm_act_bwd_stats(x, dy, mean, mul.requires_grad_(), bias, var, 0.01,
                                            1e-5)


def test_remat_on_and_off_give_the_same_gradients_on_k1(cuda):
    """The tiny plan on K1 in bf16 (cuDNN deterministic): remat on and off
    give the same loss and gradients bit for bit (K1's forward repeats its
    bits when remat recomputes a block)."""
    plan = _tiny_plan()
    x = torch.randn(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(4)).to(cuda)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        results = []
        for remat in (True, False):
            model = init_weights(UNet3D(plan, remat=remat), torch.Generator().manual_seed(0))
            model = model.to(cuda, memory_format=torch.channels_last_3d)
            loss = sum(o.float().square().mean() for o in model(x, deep_supervision=True))
            results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (l1, g1), (l2, g2) = results
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_predict_case_full_batch_equals_one_case_runs(cuda):
    """The serving burst at B = 2 on the card (bf16, N4, 8 flips): masks
    > 99.9% equal to two one-case runs, fg within atol 5e-3, one launch of
    each K1 kernel a block and flip for the batch."""
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor

    plan = _tiny_plan()
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(3))
    pred = SlidingWindowPredictor(model, plan, device=cuda)
    g = torch.Generator().manual_seed(4)
    grid = torch.stack(torch.meshgrid(*[torch.linspace(-1, 1, s) for s in (32, 36, 28)],
                                      indexing="ij")).pow(2).sum(0).sqrt()
    vols = torch.stack([(grid < 0.8) * (300 + 60 * torch.rand(grid.shape, generator=g))
                        for _ in range(2)]).numpy()
    before = kernels.instance_norm_stats.launches
    batch = [o.cpu() for o in pred.predict_case_full_batch(vols, (2.0, 2.0, 2.0), apply_n4=True)]
    torch.cuda.synchronize()
    assert kernels.instance_norm_stats.launches - before == len(ALL_FLIPS) * (4 * 2 + 2)
    for i, vol in enumerate(vols):
        solo = [o.cpu() for o in pred.predict_case_full(vol, (2.0, 2.0, 2.0), apply_n4=True)]
        for k in (1, 2, 3):
            assert (batch[k][i] == solo[k]).float().mean() > 0.999, (i, k)
        assert float((batch[4][i] - solo[4]).abs().max()) < 5e-3
        torch.testing.assert_close(batch[0][i], solo[0], rtol=1e-3, atol=1e-3)


def test_mesh_on_one_card_median_is_k2_bit_for_bit(cuda):
    """An 8-shard mesh naming this card eight times: the halo-sharded median
    (K2 once a slab, halos through the mesh's exchange) equals K2 on the
    whole volume, depth not a multiple of 8 included."""
    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.parallel.spatial import HaloShardedOps

    ops = HaloShardedOps(Mesh([cuda] * 8))
    g = torch.Generator(device=cuda).manual_seed(5)
    for shape in ((64, 40, 36), (61, 33, 29)):
        vol = torch.randn(shape, generator=g, device=cuda)
        before = kernels.median3.launches
        got = ops.median_filter(vol, 3)
        torch.cuda.synchronize()
        assert kernels.median3.launches - before == 8
        assert torch.equal(got, kernels.median3(vol))


def test_mesh_on_one_card_fg_is_unsharded_bit_for_bit(cuda):
    """The 8 flips one a shard: the psum adds in the unsharded sweep's order,
    so the fg probability has its bits; K1's two kernels run in every
    shard's forward (one a block and flip)."""
    from deepwmh_tpu_torch.parallel.infer_sharded import ShardedSlidingWindowPredictor
    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.unet.infer import ALL_FLIPS, SlidingWindowPredictor

    plan = _tiny_plan()
    model = init_weights(UNet3D(plan), torch.Generator().manual_seed(6))
    single = SlidingWindowPredictor(model, plan, mode="fullvol", device=cuda)
    sharded = ShardedSlidingWindowPredictor(model, plan, Mesh([cuda] * 8), tta=True,
                                            mode="fullvol", device=cuda)
    vol = torch.randn((32, 36, 28), generator=torch.Generator().manual_seed(7)).to(cuda)
    before = kernels.instance_norm_stats.launches
    got = sharded.predict_volume(vol)
    torch.cuda.synchronize()
    assert kernels.instance_norm_stats.launches - before == len(ALL_FLIPS) * (4 * 2 + 2)
    assert torch.equal(got, single.predict_volume(vol))


def test_mesh_on_one_card_dp_step_keeps_replicas_equal(cuda, tmp_path):
    """A data-parallel f32 step (TF32 off) over Mesh([cuda] * 2): both
    replicas hold the same bits after it, and its loss is the unsharded
    step's within rtol 1e-5."""
    import numpy as np

    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.unet.train import TrainConfig, Trainer

    rng = np.random.RandomState(0)
    images = rng.randn(2, 16, 16, 16).astype(np.float32)
    labels = (images + 0.5 * rng.randn(2, 16, 16, 16) > 1.0).astype(np.int32)
    cfg = TrainConfig(epochs=1, batches_per_epoch=1, augment=False)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = Trainer(_tiny_plan(), cfg, str(tmp_path / "one"), device=cuda,
                      dtype=torch.float32)
        one.init_state(0)
        sharded = Trainer(_tiny_plan(), cfg, str(tmp_path / "mesh"), dtype=torch.float32,
                          mesh=Mesh([cuda] * 2))
        sharded.load_state_trees(*one.state_trees())
        want = float(one.train_step(*one._to_device(images, labels), one.lr_at(0)))
        got = float(sharded.train_step(*sharded._to_device(images, labels), sharded.lr_at(0)))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    a, b = sharded.replicas
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_mesh_on_one_card_register_pairs_is_one_by_one(cuda):
    """register_pairs_mesh over Mesh([cuda] * 2), three pairs (the padding
    path): each shard's block of two (the last pair repeated) bit-equal to
    one _pair_core_batch of that block on the card."""
    import numpy as np

    from deepwmh_tpu_torch.parallel.mesh import Mesh
    from deepwmh_tpu_torch.registration.affine import (
        AffineConfig,
        feasible_affine_cfg,
        spacing_tensor,
    )
    from deepwmh_tpu_torch.registration.group import _pair_core_batch, _to_host, register_pairs_mesh
    from deepwmh_tpu_torch.registration.svf import SVFConfig, _feasible_cfg

    shape = (32, 36, 28)
    rng = np.random.RandomState(1)
    fixed = (rng.rand(3, *shape) * 100).astype(np.float16)
    moving = (rng.rand(3, *shape) * 100).astype(np.float16)
    acfg, scfg = AffineConfig(shrinks=(2,), iters=(20,)), SVFConfig(shrinks=(2,), iters=(5,))
    sp = spacing_tensor((1.0, 1.0, 1.0), cuda)
    got = register_pairs_mesh(fixed, moving, (1.0,) * 3, (1.0,) * 3, Mesh([cuda] * 2),
                              affine_cfg=acfg, svf_cfg=scfg)
    for block in ([0, 1], [2, 2]):
        want = _to_host(_pair_core_batch(torch.from_numpy(fixed[block]).to(cuda),
                                         torch.from_numpy(moving[block]).to(cuda), sp, sp,
                                         feasible_affine_cfg(acfg, shape),
                                         _feasible_cfg(scfg, shape), True))
        rows = sorted(set(block))
        for k in range(5):
            assert np.array_equal(got[k][rows], want[k][:len(rows)]), (block, k)


def test_pair_core_batch_on_card_within_one_pair_bars(cuda):
    """Two pairs as one batch on the card against each pair alone, on a
    short schedule (the one-pair bars of tests/test_torch_port_group.py:
    matrix 2e-3, field 0.05 voxel, image 1% of the range)."""
    import numpy as np

    from deepwmh_tpu_torch.registration.affine import AffineConfig, spacing_tensor
    from deepwmh_tpu_torch.registration.group import _pair_core, _pair_core_batch, _to_host
    from deepwmh_tpu_torch.registration.svf import SVFConfig

    shape = (32, 32, 32)
    g = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    rs = np.random.RandomState(2)

    def blob(stretch, shift):
        r = np.sqrt((g[0] * stretch + shift) ** 2 + g[1] ** 2 + (g[2] / stretch) ** 2)
        return ((r < 0.7) * (100 + 20 * rs.rand(*shape))).astype(np.float16)

    fixed = np.stack([blob(1.0, 0.0), blob(1.05, 0.02)])
    moving = np.stack([blob(1.1, 0.06), blob(0.95, -0.05)])
    acfg = AffineConfig(shrinks=(4,), iters=(1,))
    scfg = SVFConfig(shrinks=(4,), iters=(2,), n_squaring=4, exact_polish_iters=1)
    sp = spacing_tensor((1.0, 1.0, 1.0), cuda)
    got = _to_host(_pair_core_batch(torch.from_numpy(fixed).to(cuda),
                                    torch.from_numpy(moving).to(cuda), sp, sp, acfg, scfg, True))
    for i in range(2):
        one = _to_host(_pair_core(torch.from_numpy(fixed[i]).to(cuda),
                                  torch.from_numpy(moving[i]).to(cuda), sp, sp, acfg, scfg, True))
        assert np.abs(got[0][i] - one[0]).max() <= 2e-3
        assert np.abs(got[2][i].astype(np.float32) - one[2].astype(np.float32)).max() <= 0.05
        span = float(fixed[i].max()) - float(fixed[i].min())
        assert (np.abs(got[4][i].astype(np.float32) - one[4].astype(np.float32)).max()
                <= 1e-2 * span)


def _learned_stats_shapes():
    """[1, *spatial, C] of every K1 call of the learned registration
    network on the flagship cohort's 96x112x96 template grid."""
    from chip_smoke import learned_stats_shapes

    return [(1,) + spatial + (c,) for spatial, c, _ in learned_stats_shapes((96, 112, 96))]


def test_k1_at_learned_registration_shapes(cuda):
    """C = 8 (one 16-byte group a row in bf16), 16, 32 and the bottleneck:
    statistics within 1e-4 of the plain version with the same bits on a
    second call, the apply pass bit-equal to the plain chain."""
    g = torch.Generator(device=cuda).manual_seed(5)
    shapes = _learned_stats_shapes()
    assert [s[-1] for s in shapes] == [8, 16, 32, 32]
    slope = float(torch.tensor(0.01, dtype=torch.bfloat16))
    for shape in shapes:
        x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(torch.bfloat16)
        first, second = kernels.instance_norm_stats(x), kernels.instance_norm_stats(x)
        ref_mean, ref_var = kernels.instance_norm_stats_reference(x)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]), shape
        torch.testing.assert_close(first[0], ref_mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(first[1], ref_var, atol=1e-4, rtol=1e-4)
        mul = torch.rsqrt(first[1].clamp_min(0.0) + 1e-5)
        bias = torch.linspace(-0.5, 0.5, shape[-1], device=cuda)
        out = kernels.instance_norm_act(x, first[0], mul, bias, slope)
        want = kernels.instance_norm_act_reference(x, first[0], mul, bias, slope)
        assert torch.equal(out, want), shape


def test_sample_channels_on_card_equals_cpu(cuda):
    """The squaring's 3-channel gather at the preset's 48x56x48 level, with
    coordinates reaching past every face: the card's values equal the
    CPU's (elementwise ops in the same order, no reduction)."""
    from deepwmh_tpu_torch.ops.warp import identity_grid, sample_channels

    g = torch.Generator().manual_seed(2)
    shape = (48, 56, 48)
    field = torch.randn((3,) + shape, generator=g) * 4
    coords = identity_grid(shape) + field
    want = sample_channels(field, coords)
    got = sample_channels(field.to(cuda), coords.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_run_train_on_card(cuda, tmp_path):
    """The whole training flow on the card (tests/test_train_pipeline_e2e.py's
    cohort, the default device): every marker, the release, and K1 (the
    2-4 and 3-5 sweeps) and K2 (stage-1's median) launched. The CPU tests'
    base-4 plan: K1 reads widths 4 and 8 (the narrow path since B0)."""
    import os

    from deepwmh_tpu_torch.cli.train import run_train
    from deepwmh_tpu_torch.pipeline.multistage import StageBudget
    from torch_port_cohort import BUDGET, MARKERS, write_e2e_cohort

    ref_csv, tr_csv, _ = write_e2e_cohort(str(tmp_path))
    before = {name: k.launches for name, k in kernels.KERNELS.items()}
    core = run_train(ref_csv, tr_csv, str(tmp_path / "out"), skip_bfc=True,
                     budget=StageBudget(**BUDGET))
    for m in MARKERS:
        assert os.path.isfile(os.path.join(core, "Checkpoints", m)), m
    assert os.path.isfile(os.path.join(core, "Model_release", "model_release.tar.gz"))
    launched = {name: k.launches - before[name] for name, k in kernels.KERNELS.items()}
    assert launched["median3"] == 2  # one per training case
    assert launched["instance_norm_stats"] > 0 and launched["instance_norm_act"] > 0


def _lesion_masks(seed, shape=(40, 48, 36)):
    """(pred, truth) f32 numpy masks with many components and size ties."""
    import numpy as np

    rng = np.random.RandomState(seed)
    truth = rng.rand(*shape) < 0.03
    for _ in range(60):
        c = [rng.randint(1, s - 4) for s in shape]
        e = rng.randint(1, 4, 3)
        truth[c[0]:c[0] + e[0], c[1]:c[1] + e[1], c[2]:c[2] + e[2]] = True
    pred = (np.roll(truth, 1, axis=seed % 3) & (rng.rand(*shape) < 0.9)) | (rng.rand(*shape) < 0.02)
    return pred.astype(np.float32), truth.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_on_card_equal_cpu(cuda, seed):
    """Components labelled on the card give the CPU's counts, per-lesion
    Dice lists and rows exactly."""
    from deepwmh_tpu_torch.eval import metrics

    pred, truth = _lesion_masks(seed)
    for a, b in ((pred, truth), (truth, pred)):
        assert metrics.instance_confusion(a, b, device=cuda) == \
            metrics.instance_confusion(a, b, device="cpu")
        assert metrics.binary_component_dice(a, b, device=cuda) == \
            metrics.binary_component_dice(a, b, device="cpu")
    assert metrics.evaluate_masks(pred, truth, metrics.METRICS, device=cuda) == \
        metrics.evaluate_masks(pred, truth, metrics.METRICS, device="cpu")
    t = torch.from_numpy(truth)
    assert metrics.instance_f1(t.to(cuda), t.to(cuda)) == 1.0


def _converted(tmp_path, base):
    from torch_port_nnunet import plans_dict, seeded_replica, write_reference_install

    from deepwmh_tpu_torch.unet.torch_convert import convert_nnunet_model, find_nnunet_checkpoint

    pools, convs = [[2, 2, 2], [1, 2, 2]], [[3, 3, 3]] * 3
    net = seeded_replica(pools, convs, base=base, seed=0)
    write_reference_install(str(tmp_path / "ref"), net,
                            plans_dict(pools, convs, (16, 16, 16), (1.0, 1.0, 1.0), base=base))
    return net, convert_nnunet_model(*find_nnunet_checkpoint(str(tmp_path / "ref")),
                                     str(tmp_path / "pkg"))


def test_converted_model_k1_forward_equals_plain(cuda, tmp_path):
    """A converted package on the card (f32, TF32 off): the K1 forward
    within K1's tolerances of the same weights on the plain chain, and of
    the replica within the conversion's (atol 2e-4, rtol 1e-3)."""
    from deepwmh_tpu_torch.unet.release import load_released_model

    net, pkg = _converted(tmp_path, base=8)
    model, plan = load_released_model(pkg, device=cuda, dtype=torch.float32)
    plain = UNet3D(plan, dtype=torch.float32, fused_norm=False)
    plain.load_state_dict(model.state_dict())
    plain = plain.to(cuda, memory_format=torch.channels_last_3d).eval()
    x = torch.randn((1, 1, 16, 24, 16), generator=torch.Generator().manual_seed(1)).to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            before = kernels.instance_norm_stats.launches
            got = model(x, deep_supervision=True)
            torch.cuda.synchronize()
            launched = kernels.instance_norm_stats.launches - before
            want = plain(x, deep_supervision=True)
            ref = net.to(cuda)(x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert launched == 4 * plan.num_pools + 2
    for g, w, r in zip(got, want, reversed(ref)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-3)


def test_converted_narrow_model_refuses_on_card(cuda, tmp_path):
    """A converted plan of width 3 (neither a multiple nor a divisor of 8
    bf16 lanes) raises on the card with K1's message; it never slips onto
    the plain chain. Width 4 runs K1's narrow path since fault B0, within
    K1's tolerances of the plain chain."""
    from deepwmh_tpu_torch.unet.release import load_released_model

    _net, pkg = _converted(tmp_path / "w3", base=3)
    model, _plan = load_released_model(pkg, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="C % 8"):
        model(torch.randn(1, 1, 16, 16, 16, device=cuda))
    _net, pkg = _converted(tmp_path / "w4", base=4)
    model, plan = load_released_model(pkg, device=cuda, dtype=torch.float32)
    plain = UNet3D(plan, dtype=torch.float32, fused_norm=False)
    plain.load_state_dict(model.state_dict())
    plain = plain.to(cuda, memory_format=torch.channels_last_3d).eval()
    x = torch.randn((1, 1, 16, 24, 16), generator=torch.Generator().manual_seed(1)).to(cuda)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            before = kernels.instance_norm_stats.launches
            got = model(x, deep_supervision=True)
            torch.cuda.synchronize()
            launched = kernels.instance_norm_stats.launches - before
            want = plain(x, deep_supervision=True)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert launched == 4 * plan.num_pools + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_native_host_library_builds_here(cuda):
    """The DICOM import's host library builds from the checkout with this
    machine's g++ into deepwmh_tpu_torch/_build/ and loads."""
    import os

    from deepwmh_tpu_torch import native

    path = native.build()
    assert os.path.isfile(path) and os.path.dirname(path) == native.BUILD_DIR
    assert native.get_lib() is not None


@pytest.mark.parametrize("route", ["jpegl_decode_diffs", "jpegl_reconstruct", "jls_decode_scan"])
def test_native_import_equals_python_on_port_streams(cuda, route):
    """Each native route against its Python version on streams the port's
    encoders make of a 224x192 slice, bit for bit, each path counted."""
    import numpy as np

    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.core import jlscodec, jpegcodec

    rng = np.random.RandomState(0)
    g = np.meshgrid(np.linspace(-1, 1, 224), np.linspace(-1, 1, 192), indexing="ij")
    img = ((np.hypot(*g) < 0.85) * (400 + 150 * rng.rand(224, 192))).astype(np.uint16)
    if route == "jls_decode_scan":
        stream, decode = jlscodec.encode(img, precision=12), jlscodec.decode
    else:
        predictor = 1 if route == "jpegl_decode_diffs" else 7
        stream = jpegcodec.encode_lossless(img, predictor=predictor, precision=16)
        decode = jpegcodec.decode
    native.reset_counts()
    got = decode(stream)[0]
    assert native.CALLS[route] == 1 and sum(native.PYTHON_CALLS.values()) == 0
    with native.python_path():
        want = decode(stream)[0]
    assert native.PYTHON_CALLS[route] == 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("density", [0.02, 0.2, 0.5])
def test_native_labelling_equals_card_label_components(cuda, density):
    """``cc3d.cpp``'s host labelling of a flagship-size 192x224x192 mask
    against ``ops/components.label_components`` on the card, its root
    labels (each component's minimum linear index) compacted to 1..n in
    ascending order: the same ids and count."""
    import numpy as np

    from deepwmh_tpu_torch import native
    from deepwmh_tpu_torch.ops.components import label_components

    m = np.random.RandomState(int(density * 100)).rand(192, 224, 192) < density
    labels, n = native.label_components_host(m)
    root = label_components(torch.from_numpy(m).to(cuda)).reshape(-1)
    N = root.numel()
    rank = torch.cumsum(root == torch.arange(N, device=cuda), 0)
    ids = torch.where(root < N, rank[root.clamp(max=N - 1)], 0).reshape(m.shape)
    assert n == int(rank[-1]) > 0
    np.testing.assert_array_equal(ids.cpu().numpy(), labels)
