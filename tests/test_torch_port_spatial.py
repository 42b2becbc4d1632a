"""deepwmh_tpu_torch.parallel.spatial (halo-sharded whole-volume ops) on CPU
meshes (``Mesh([cpu] * n)``) against the port's unsharded ops and against
the JAX package's ``HaloShardedOps`` on the 8-virtual-device mesh of
tests/conftest.py at the same n, and ops/n4.py's sharded route.

Tolerances: the window filters are exact against the port's own (the zero
halos are the filters' zero boundary; the median runs K2's plain version
once a slab) and within the JAX test's 1e-6 / 1e-5 of JAX's; z-score 1e-5;
mean_std_grid the JAX test's 2e-5 / 2e-4 (f32 cell sums in another
order); N4 rel < 1e-3 in the brain, the JAX test's bar. Sharded N4 takes
its histogram's quarter sample per slab, as JAX's does: against the
port's unsharded N4 it is held where every slab's working depth is even
(the slabs' samples then make up the whole volume's), against JAX's
sharded N4 at every n.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from deepwmh_tpu.parallel.spatial import HaloShardedOps as JHaloShardedOps
from deepwmh_tpu_torch.ops import filters, grid, n4, stats
from deepwmh_tpu_torch.parallel import mesh as pmesh
from deepwmh_tpu_torch.parallel.spatial import HaloShardedOps, halo_pad_local

N4_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def ops_pair(n):
    """(port ops on Mesh([cpu] * n), JAX ops on the first n virtual devices)."""
    if jax.device_count() < n:
        pytest.skip("needs %d virtual JAX devices" % n)
    return (HaloShardedOps(pmesh.Mesh([torch.device("cpu")] * n)),
            JHaloShardedOps(JMesh(np.array(jax.devices()[:n]), ("dp",))))


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("shape", [(32, 12, 10), (27, 9, 11)])  # and ragged
@pytest.mark.parametrize("k", [3, 5])
def test_sharded_filters_match(n, shape, k):
    ops, jops = ops_pair(n)
    x = np.random.RandomState(0).rand(*shape).astype(np.float32) * 100
    for name in ("median_filter", "mean_filter", "min_filter", "max_filter"):
        got = getattr(ops, name)(torch.from_numpy(x), k).numpy()
        want = getattr(filters, name)(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(getattr(jops, name)(x, k)), rtol=1e-6,
                                   atol=1e-5, err_msg=name)


def test_sharded_median_runs_k2_once_a_slab(monkeypatch):
    from deepwmh_tpu_torch.ops import kernels

    calls = []
    monkeypatch.setattr(kernels, "median3", lambda v: calls.append(v.shape) or
                        kernels.median3_reference(v))
    ops = HaloShardedOps(pmesh.Mesh(["cpu"] * 4))
    x = torch.rand(27, 9, 11)
    got = ops.median_filter(x, 3)
    assert calls == [(9, 9, 11)] * 4  # 7 rows a slab (27 padded to 28) + 2 halo rows
    assert torch.equal(got, kernels.median3_reference(x))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_zscore_matches(n):
    ops, jops = ops_pair(n)
    rng = np.random.RandomState(1)
    x = rng.rand(26, 10, 8).astype(np.float32) * 50
    mask = (rng.rand(26, 10, 8) > 0.4).astype(np.float32)
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        got = ops.z_score(torch.from_numpy(x), mask=tm).numpy()
        np.testing.assert_allclose(got, stats.z_score(torch.from_numpy(x), tm).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jops.z_score(x, mask=m)), rtol=1e-5,
                                   atol=1e-5)


def test_map_overlap_custom_fn():
    """A custom stencil through the generic primitive: 3-row running sum."""
    ops = HaloShardedOps(pmesh.Mesh(["cpu"] * 8))
    x = torch.from_numpy(np.random.RandomState(2).rand(24, 6, 5).astype(np.float32))

    def stencil(v):
        z = torch.zeros_like(v[:1])
        return torch.cat([z, v[:-1]]) + v + torch.cat([v[1:], z])

    torch.testing.assert_close(ops.map_overlap(stencil, x, halo=1), stencil(x), rtol=1e-6,
                               atol=1e-6)


def test_halo_too_large_raises():
    ops = HaloShardedOps(pmesh.Mesh(["cpu"] * 8))
    with pytest.raises(ValueError, match="halo"):
        ops.map_overlap(lambda v: v, torch.rand(8, 4, 4), halo=3)  # 1 row a shard


def test_halo_pad_local_exchanges_neighbour_rows():
    mesh = pmesh.Mesh(["cpu"] * 3)
    slabs = [torch.full((2, 1, 1), float(d + 1)) for d in range(3)]
    ext = halo_pad_local(mesh, slabs, 1)
    assert [e.flatten().tolist() for e in ext] == [[0, 1, 1, 2], [1, 2, 2, 3], [2, 3, 3, 0]]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_mean_std_grid_matches(n):
    ops, jops = ops_pair(n)
    rng = np.random.RandomState(3)
    vol = rng.rand(37, 22, 18).astype(np.float32) * 100
    mask = (rng.rand(37, 22, 18) > 0.3).astype(np.float32)
    for patch in [(10, 10, 10), (7, 9, 5)]:
        for m in (None, mask):
            tm = None if m is None else torch.from_numpy(m)
            for order in (0, 1):
                got = ops.mean_std_grid(torch.from_numpy(vol), patch, mask=tm, order=order)
                ref = grid.mean_std_grid(torch.from_numpy(vol), patch, mask=tm, order=order)
                jref = jops.mean_std_grid(vol, patch, mask=m, order=order)
                for g, r, j, tol in zip(got, ref, jref, (2e-5, 2e-4)):
                    msg = "patch=%s mask=%s order=%d" % (patch, m is not None, order)
                    np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=tol, atol=tol,
                                               err_msg=msg)
                    np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=tol, atol=tol,
                                               err_msg=msg)


def _biased_head(shape, seed, tilt):
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    brain = np.sqrt(sum(a ** 2 for a in g)) < 0.85
    bias = np.exp(tilt[0] * g[0] + tilt[1] * g[1])
    rng = np.random.RandomState(seed)
    return (brain * 200.0 * bias * (1 + 0.05 * rng.rand(*shape))).astype(np.float32), brain


def _rel(got, want, brain):
    return (np.abs(got[brain] - want[brain]) / np.maximum(np.abs(want[brain]), 1.0)).max()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("shape", [(64, 24, 20), (53, 22, 19)])  # aligned, unaligned
def test_sharded_n4_matches(n, shape):
    """Sharded N4 against JAX's sharded N4 at the same n, and against the
    port's unsharded N4 where the slabs' quarter samples make up the whole
    volume's (even working depth a slab); the bias is reduced."""
    ops, jops = ops_pair(n)
    vol, brain = _biased_head(shape, seed=n, tilt=(0.4, 0.25))
    kw = dict(levels=2, iters_per_level=10)
    got, bias = ops.n4_bias_correction(torch.from_numpy(vol), return_bias=True, **kw)
    got = got.numpy()
    assert got.shape == bias.shape == shape and np.isfinite(got).all()
    rel_jax = _rel(got, np.asarray(jops.n4_bias_correction(vol, **kw)), brain)
    print("n4 n=%d %s: rel to JAX sharded %.2e" % (n, shape, rel_jax))
    assert rel_jax < N4_REL
    rows_small = -(-shape[0] // (2 * n))  # working rows a slab
    if rows_small % 2 == 0:
        want = n4.n4_bias_correction(torch.from_numpy(vol), **kw).numpy()
        assert _rel(got, want, brain) < N4_REL
    cv = lambda a: a[brain].std() / a[brain].mean()  # noqa: E731
    assert cv(got) < cv(vol) * 0.7


def test_sharded_n4_repeats_and_is_unsharded_at_one_shard():
    vol, _ = _biased_head((40, 20, 18), seed=5, tilt=(0.3, 0.2))
    kw = dict(levels=2, iters_per_level=5)
    one = HaloShardedOps(pmesh.Mesh(["cpu"])).n4_bias_correction(torch.from_numpy(vol), **kw)
    assert torch.equal(one, n4.n4_bias_correction(torch.from_numpy(vol), **kw))
    ops = HaloShardedOps(pmesh.Mesh(["cpu"] * 4))
    assert torch.equal(ops.n4_bias_correction(torch.from_numpy(vol), **kw),
                       ops.n4_bias_correction(torch.from_numpy(vol), **kw))


@pytest.mark.parametrize("case,cuda,count,pinned,voxels,want", [
    ("small volume", True, 4, False, 1000, False),
    ("several cards", True, 4, False, None, True),
    ("one card", True, 1, False, None, False),
    ("pinned", True, 4, True, None, False),
    ("no card", False, 0, False, None, False),
])
def test_n4_would_shard(monkeypatch, case, cuda, count, pinned, voxels, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    shape = (10, 10, 10) if voxels else (400, 400, 400)
    assert n4.N4_SHARD_MIN_VOXELS <= 400 ** 3
    assert n4.n4_would_shard(shape, pinned=pinned) is want, case


def test_n4_auto_routes_to_the_sharded_n4(monkeypatch):
    """Above the threshold with several cards (faked) and the run not
    pinned, the auto router runs HaloShardedOps(make_mesh()); pinned, the
    single-device N4."""
    vol, _ = _biased_head((32, 16, 14), seed=6, tilt=(0.3, 0.2))
    x = torch.from_numpy(vol)
    kw = dict(levels=1, iters_per_level=4)
    cpu_mesh = pmesh.Mesh(["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(n4, "N4_SHARD_MIN_VOXELS", 1000)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **k: cpu_mesh)
    sharded = HaloShardedOps(cpu_mesh).n4_bias_correction(x, **kw)
    assert torch.equal(n4.n4_bias_correction_auto(x, **kw), sharded)
    assert torch.equal(n4.n4_bias_correction_auto(x, pinned=True, **kw),
                       n4.n4_bias_correction(x, **kw))
