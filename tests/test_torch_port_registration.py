"""deepwmh_tpu_torch registration pieces against the JAX package on the CPU:
warp (``sample_channels`` and the compositions), similarity, affine and
SVF. The same numpy inputs from a seed go through both; the tolerance of
each test is in it:

- values rtol 1e-5 (f32 sums in other orders), order-0 sampling exactly;
- ``torch.autograd`` gradients against ``jax.grad`` at rtol 1e-4, atol 1e-6
  (per element, of gradients whose largest element is ~1e-4..1e-1);
- the pass-through exp VJP returns the cotangent bit for bit;
- ``_optimize_level`` / ``_optimize_svf_level`` after 1 and 5 Adam steps
  within 1e-5 / 1e-4 (absolute, parameters and fields of magnitude ~1).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepwmh_tpu.ops import warp as jwarp
from deepwmh_tpu.registration import affine as jaffine
from deepwmh_tpu.registration import similarity as jsim
from deepwmh_tpu.registration import svf as jsvf
from deepwmh_tpu_torch.ops import warp
from deepwmh_tpu_torch.registration import affine, similarity, svf


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny products run single-threaded: with the test workers sharing the
    cores, torch's thread pool turns a 3x512 product into milliseconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def make_brain(shape=(32, 32, 32), seed=0):
    """A head with an off-centre bright structure (as the JAX tests' phantom)."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    r = np.sqrt(sum(a ** 2 for a in g))
    vol = np.where(r < 0.7, 200.0, 0.0) + np.where(r < 0.4, 100.0, 0.0)
    vol += 10 * rng.rand(*shape)
    vol[8:14, 18:26, 10:18] += 150
    vol[20:24, 6:12, 20:26] += 120
    return vol.astype(np.float32)


def smooth_field(shape, amp, seed):
    """A smooth [3, *shape] displacement of about ``amp`` voxels."""
    rng = np.random.RandomState(seed)
    g = np.meshgrid(*[np.linspace(0, np.pi, s) for s in shape], indexing="ij")
    out = []
    for c in range(3):
        ph = rng.uniform(0, np.pi, 3)
        out.append(amp * np.sin(g[0] + ph[0]) * np.sin(g[1] + ph[1]) * np.cos(g[2] + ph[2]))
    return np.stack(out).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- warp


def test_sample_channels_and_compositions_match_jax():
    """Coordinates reaching 3 voxels past every face (the zero outside)."""
    rng = np.random.RandomState(0)
    vols = rng.randn(3, 9, 11, 7).astype(np.float32)
    coords = (rng.rand(3, 6, 5, 4) * np.array([15, 17, 13]).reshape(3, 1, 1, 1) - 3).astype(
        np.float32)
    close(warp.sample_channels(T(vols), T(coords)), jwarp.sample_channels(vols, coords))
    disp = smooth_field((9, 11, 7), 2.5, 1)
    inner = smooth_field((9, 11, 7), 1.5, 2)
    close(warp.compose_disp(T(disp), T(inner)), jwarp.compose_disp(disp, inner))
    mat = np.array([[0.9, 0.1, 0.0, 1.5], [-0.05, 1.1, 0.02, -2.0], [0.0, 0.03, 0.95, 0.5]],
                   np.float32)
    close(warp.compose_affine_then_disp(mat, T(disp)),
          jwarp.compose_affine_then_disp(mat, disp), atol=1e-5)


@pytest.mark.parametrize("order", [0, 1])
def test_displacement_warp_matches_jax(order):
    """Order 0 exactly, order 1 within rtol 1e-5."""
    vol = make_brain((20, 24, 16))
    disp = smooth_field((20, 24, 16), 3.0, 3)
    disp[0, :2] = 0.5  # exact halves: rounded away from zero
    got = warp.displacement_warp(T(vol), T(disp), order=order).numpy()
    want = np.asarray(jwarp.displacement_warp(vol, disp, order=order))
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------- similarity


def test_winsorize_and_pyramid_ops_match_jax():
    vol = make_brain()
    close(similarity.winsorize_rescale(T(vol)), jsim.winsorize_rescale(vol))
    for q in (0.0, 0.005, 0.5, 0.995, 1.0):
        close(similarity.quantile(T(vol), q), jnp.quantile(vol, q))
    for f in (1, 3, 4):
        close(similarity.downsample_mean(T(vol), f), jsim.downsample_mean(vol, f), atol=1e-4)
    field = smooth_field((10, 12, 9), 2.0, 4)
    close(similarity.grad_sq(T(field)), jsim.grad_sq(field))
    close(svf._smooth3(T(field), 1.0), jsvf._smooth3(field, 1.0))
    close(svf._resize_field(T(field), (17, 23, 15)), jsvf._resize_field(field, (17, 23, 15)))


def test_quantile_beyond_torch_quantile_limit():
    """2^24 + 7 elements (torch.quantile refuses above 2^24): against
    numpy's exact linear interpolation within rtol 1e-6 (in f32 the count
    itself rounds, moving the position by 2 of 2^24 ranks)."""
    x = np.random.RandomState(1).rand(2 ** 24 + 7).astype(np.float32)
    for q in (0.005, 0.995):
        np.testing.assert_allclose(float(similarity.quantile(T(x), q)),
                                   np.quantile(x.astype(np.float64), q), rtol=1e-6)
    assert similarity._order_stat_weights(2 ** 24 + 7, 1.0)[:2] == (2 ** 24 + 6,) * 2


def _pair(shape=(32, 32, 32)):
    fixed = np.asarray(jsim.winsorize_rescale(make_brain(shape, 0)))
    moving = np.asarray(jsim.winsorize_rescale(np.roll(make_brain(shape, 1), 2, axis=0)))
    return fixed, moving


def _grads(torch_fn, jax_fn, a, b, jit=True):
    """(torch value, torch grad in b, jax value, jax grad in b)."""
    tb = T(b).requires_grad_(True)
    val = torch_fn(T(a), tb)
    (g,) = torch.autograd.grad(val, tb)
    vg = jax.value_and_grad(jax_fn, argnums=1)
    jv, jg = (jax.jit(vg) if jit else vg)(jnp.asarray(a), jnp.asarray(b))
    return val, g, jv, jg


@pytest.mark.parametrize("radius", [2, 4])
def test_lncc_value_and_grad_match_jax(radius):
    """Against JAX's eager evaluation, whose window sums add in the same
    order. The value within rtol 1e-5 at r = 2; at r = 4 within 5e-5: the
    variance terms cancel over 729-voxel windows, and JAX's own value moves
    by 1.9e-5 between its jitted and its eager evaluation of this input
    (measured: other fusions, other roundings; its jitted gradient differs
    from its eager one in 0.1% of the voxels, near flat windows)."""
    fixed, moving = _pair()
    val, g, jv, jg = _grads(lambda a, b: similarity.lncc(a, b, radius),
                            lambda a, b: jsim.lncc(a, b, radius), fixed, moving, jit=False)
    jit_v = jax.jit(jsim.lncc, static_argnums=2)(jnp.asarray(fixed), jnp.asarray(moving), radius)
    rtol = 1e-5 if radius == 2 else 5e-5
    close(val, jv, rtol=rtol)
    close(val, jit_v, rtol=rtol)
    close(g, jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 4])
def test_mutual_information_value_and_grad_match_jax(stride):
    fixed, moving = _pair()
    a, b = fixed.reshape(-1)[::stride], moving.reshape(-1)[::stride]
    val, g, jv, jg = _grads(similarity.mutual_information, jsim.mutual_information, a, b)
    close(val, jv)
    close(g, jg, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ affine

SP = np.array([1.0, 1.0, 1.2], np.float32)
MSP = np.array([1.1, 1.0, 1.0], np.float32)


@pytest.mark.parametrize("mode,stride", [("rigid", 4), ("affine", 1)])
def test_affine_loss_grad_matches_jax(mode, stride):
    """The MI loss of a level (strided and not) and its gradient in the
    parameters."""
    fixed, moving = _pair()
    center = np.asarray(jaffine._center_of_mass(jnp.asarray(fixed), jnp.asarray(SP)))
    close(affine._center_of_mass(T(fixed), T(SP)), center, atol=1e-5)
    n = 6 if mode == "rigid" else 12
    params = np.random.RandomState(2).randn(n).astype(np.float32) * 0.05

    def jloss(p):
        mat = jaffine._params_to_matrix(p, jnp.asarray(center), mode)
        if stride > 1:
            grid = jaffine._phys_grid(fixed.shape, jnp.asarray(SP)).reshape(3, -1)[:, ::stride]
            vals = jwarp.sample_volume(jnp.asarray(moving), (mat[:, :3] @ grid + mat[:, 3:])
                                       / jnp.asarray(MSP).reshape(3, 1))
            return -jsim.mutual_information(fixed.reshape(-1)[::stride], vals)
        warped = jaffine.resample_moving(moving, mat, fixed.shape, jnp.asarray(SP),
                                         jnp.asarray(MSP))
        return -jsim.mutual_information(fixed, warped)

    def tloss(p):
        mat = affine._params_to_matrix(p, T(center), mode)
        if stride > 1:
            grid = affine._phys_grid(fixed.shape, T(SP)).reshape(3, -1)[:, ::stride]
            vals = warp.sample_volume(T(moving), (mat[:, :3] @ grid + mat[:, 3:])
                                      / T(MSP).reshape(3, 1))
            return -similarity.mutual_information(T(fixed).reshape(-1)[::stride], vals)
        warped = affine.resample_moving(T(moving), mat, fixed.shape, T(SP), T(MSP))
        return -similarity.mutual_information(T(fixed), warped)

    p = T(params).requires_grad_(True)
    val = tloss(p)
    (g,) = torch.autograd.grad(val, p)
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(params))
    close(val, jv)
    # a parameter's gradient sums ~1e4 voxel terms that cancel: within
    # rtol 1e-4 or 2e-4 of the largest element (JAX's own jitted and eager
    # gradients differ by 1.7e-4 relative on the smallest one, measured)
    close(g, jg, rtol=1e-4, atol=2e-4 * float(np.abs(jg).max()))


@pytest.mark.parametrize("iters", [1, 5])
def test_optimize_level_matches_jax(iters):
    """Rigid with strided MI at shrink 2, then affine with LNCC: 1e-5 after
    one step, 1e-4 after five. MI over a 16^3 level is chaotic: JAX's own
    five-step result moves by 3.7e-5 when its start moves by one ulp
    (measured), and the port's per-step rounding grows the same way."""
    fixed, moving = _pair()
    f = np.asarray(jsim.downsample_mean(fixed, 2))
    m = np.asarray(jsim.downsample_mean(moving, 2))
    center = np.asarray(jaffine._center_of_mass(jnp.asarray(fixed), jnp.asarray(SP)))
    for mode, metric, stride, n in (("rigid", "mi", 4, 6), ("affine", "lncc", 1, 12)):
        p0 = np.random.RandomState(n).randn(n).astype(np.float32) * 0.02
        kw = dict(mode=mode, iters=iters, lr=0.05, metric=metric, mi_bins=32, lncc_radius=2,
                  sample_stride=stride)
        jp, jl = jaffine._optimize_level(jnp.asarray(f), jnp.asarray(m), jnp.asarray(SP * 2),
                                         jnp.asarray(MSP * 2), jnp.asarray(p0),
                                         jnp.asarray(center), **kw)
        tp, tl = affine._optimize_level(T(f), T(m), T(SP * 2), T(MSP * 2), T(p0), T(center),
                                        **kw)
        close(tp, jp, rtol=0, atol=1e-5 if iters == 1 else 1e-4)
        close(tl, jl, rtol=1e-5 if iters == 1 else 1e-4)


def test_affine_core_and_apply_match_jax():
    """The whole pyramid at 32^3 (level 8 dropped, 4 and 2 kept, rigid then
    affine) and its resample: matrix within 2e-3. One step a level: longer
    runs at 8^3 and 16^3 are chaotic (JAX's own jitted pyramid and the same
    levels run one by one end 0.26 apart after two steps a level, measured;
    test_torch_port_group.py compares whole pairs by what they achieve)."""
    fixed, moving = make_brain((32, 32, 32), 0), np.roll(make_brain((32, 32, 32), 1), 2, 0)
    cfg = affine.AffineConfig(shrinks=(8, 4, 2), iters=(1, 1, 1))
    jcfg = jaffine.AffineConfig(shrinks=(8, 4, 2), iters=(1, 1, 1))
    jm, jl = jaffine.register_affine(fixed, moving, SP, MSP, cfg=jcfg)
    tm, tl = affine.register_affine(fixed, moving, SP, MSP, cfg=cfg, device="cpu")
    np.testing.assert_allclose(tm, jm, atol=2e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    close(affine.apply_affine(moving, jm, fixed.shape, SP, MSP, device="cpu"),
          jaffine.apply_affine(moving, jm, fixed.shape, SP, MSP), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(affine.invert_affine(jm), jaffine.invert_affine(jm), atol=1e-12)
    assert affine.feasible_levels((8, 4, 2), (1, 2, 3), (32, 40, 30)) == \
        jaffine.feasible_levels((8, 4, 2), (1, 2, 3), (32, 40, 30))


# --------------------------------------------------------------------- svf


def test_passthrough_vjp_returns_cotangent():
    v = T(smooth_field((8, 9, 7), 1.0, 5)).requires_grad_(True)
    ct = torch.randn(3, 8, 9, 7, generator=torch.Generator().manual_seed(0))
    out = svf.scaling_and_squaring_approx_grad(v, 3)
    (g,) = torch.autograd.grad(out, v, ct)
    assert torch.equal(g, ct)
    assert torch.equal(out.detach(), svf.scaling_and_squaring(v.detach(), 3))


@pytest.mark.parametrize("exact", [False, True])
def test_svf_loss_grad_matches_jax(exact):
    """The SVF level loss (smoothing, 4 squarings, warp, LNCC, bending) and
    its gradient in v, first-order and exact exp gradients."""
    fixed, moving = _pair((16, 20, 16))
    v0 = smooth_field((16, 20, 16), 1.5, 6)
    exp_t = svf.scaling_and_squaring if exact else svf.scaling_and_squaring_approx_grad
    exp_j = jsvf.scaling_and_squaring if exact else jsvf.scaling_and_squaring_approx_grad

    def jloss(f, v):
        vs = jsvf._smooth3(v, 1.0)
        warped = jwarp.displacement_warp(jnp.asarray(moving), exp_j(vs, 4))
        return -jsim.lncc(f, warped, radius=2) + jsim.grad_sq(vs)

    def tloss(f, v):
        vs = svf._smooth3(v, 1.0)
        warped = warp.displacement_warp(T(moving), exp_t(vs, 4))
        return -similarity.lncc(f, warped, radius=2) + similarity.grad_sq(vs)

    val, g, jv, jg = _grads(tloss, jloss, fixed, v0, jit=False)
    close(val, jv)
    close(g, jg, rtol=1e-4, atol=1e-6)
    close(svf.scaling_and_squaring(T(v0), 4), jsvf.scaling_and_squaring(v0, 4), atol=1e-5)


@pytest.mark.parametrize("iters", [1, 5])
def test_optimize_svf_level_matches_jax(iters):
    """First-order then exact steps from the same field: 99.9% of the
    field within 1e-4, all of it within 1e-3. Adam's first step is
    lr * g / (|g| + eps): where g is within rounding of 0 it moves the
    element by up to 2 lr |dg| / (|g| + eps) (one element of 15360 here,
    by 2e-4; JAX's own field moves by 9e-5 when its start moves by one ulp,
    measured)."""
    fixed, moving = _pair((16, 20, 16))
    v0 = smooth_field((16, 20, 16), 1.0, 7)
    for exact in (False, True):
        kw = dict(iters=iters, lr=0.25, n_squaring=2, lncc_radius=2, bending=1.0, sigma=1.0,
                  exact_exp_grad=exact)
        jv, jl = jsvf._optimize_svf_level(jnp.asarray(fixed), jnp.asarray(moving),
                                          jnp.asarray(v0), **kw)
        tv, tl = svf._optimize_svf_level(T(fixed), T(moving), T(v0), **kw)
        gap = np.abs(tv.numpy() - np.asarray(jv))
        assert (gap <= 1e-4).mean() >= 0.999 and gap.max() <= 1e-3, gap.max()
        close(tl, jl, rtol=1e-5)


def test_svf_core_and_apply_match_jax():
    """The pyramid at 32^3 with a warm seed and the polish split, a few
    steps a level: the field within 0.05 voxel (the one-pair bar; measured
    2.5e-3). Then the [affine, warp] resample: order 1 rtol 1e-5, order 0
    at least 99.5% equal."""
    fixed, moving = make_brain((32, 32, 32), 0), make_brain((32, 32, 32), 2)
    kw = dict(shrinks=(2,), iters=(3,), n_squaring=4, exact_polish_iters=1)
    v0 = smooth_field((8, 8, 8), 1.0, 8)
    jd, jl = jax.jit(jsvf._svf_core, static_argnums=2)(
        jnp.asarray(fixed), jnp.asarray(moving), jsvf.SVFConfig(**kw), jnp.asarray(v0))
    td, tl = svf._svf_core(T(fixed), T(moving), svf.SVFConfig(**kw), v0=T(v0))
    close(td, jd, rtol=0, atol=0.05)
    close(tl, jl, rtol=1e-4)
    mat = np.array([[1.0, 0.02, 0.0, 0.4], [0.0, 0.98, 0.0, -0.3], [0.01, 0.0, 1.02, 0.2]],
                   np.float32)
    for order in (0, 1):
        got = svf.apply_affine_svf(T(moving), mat, T(np.asarray(jd)), fixed.shape, SP, MSP,
                                   order=order).numpy()
        want = np.asarray(jsvf.apply_affine_svf(moving, mat, jd, fixed.shape, SP, MSP,
                                                order=order))
        if order:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        else:
            assert (got == want).mean() >= 0.995
