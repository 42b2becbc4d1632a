"""Halo-sharded whole-volume ops over a device mesh (port of
``deepwmh_tpu.parallel.spatial``).

A [D, H, W] volume is cut along D into equal slabs, one a shard (the depth
is zero-padded to a multiple of the shard count and the result cropped).
Window ops extend each slab with ``halo`` rows from its neighbours through
the mesh's neighbour exchange (``mesh.ppermute``, which fills the outer
halos of the first and last slab with zeros) and crop them from the
result. The single-device filters use that zero boundary too, so the
sharded filters are exact; the 3x3x3 median runs K2 once a slab. Global
statistics add per-shard partial sums with ``psum`` (padding rows weigh
0), and only small arrays (N4's histogram and control lattice, the
mean/std cell grid) are ever whole: each shard computes its own rows of
every full-resolution array.

The exchanges go through the mesh even when the shards share one device,
so a one-card mesh runs the code a multi-card node runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deepwmh_tpu_torch.ops import filters
from deepwmh_tpu_torch.ops.grid import (
    _shift_add,
    linear_resize_axis,
    nearest_resize_axis,
)
from deepwmh_tpu_torch.ops.n4 import (
    CHEB_K,
    NBINS,
    _bspline_upsample_axis,
    _cheb_pinv,
    _clenshaw,
    _cubic_bspline_weights,
    _expectation_map,
    _fixed_histogram,
    _from_fixed,
    _histogram_sample,
    _intensity_range,
    _bin_positions,
    _bin_width,
    _shrink,
)
from deepwmh_tpu_torch.ops.stats import EPS_STD
from deepwmh_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    ppermute,
    psum,
    to_device,
)


def _pad_rows(x, multiple: int):
    """``x`` zero-padded at the end of axis 0 to a multiple; (x, rows added)."""
    pad = (-x.shape[0]) % multiple
    if pad:
        x = F.pad(x, [0, 0] * (x.dim() - 1) + [0, pad])
    return x, pad


def halo_pad_local(mesh: Mesh, slabs, halo: int):
    """Each slab extended with ``halo`` rows of each neighbour's (the
    counterpart of the JAX function run inside ``shard_map``): the first
    and last slab receive zeros outside the volume, the single-device ops'
    zero window padding."""
    if halo <= 0:
        return list(slabs)
    depth = slabs[0].shape[0]
    if halo > depth:
        raise ValueError("halo %d exceeds the local shard depth %d — use fewer shards "
                         "for this volume" % (halo, depth))
    n = mesh.size
    from_prev = ppermute(mesh, [s[-halo:] for s in slabs], [(i, i + 1) for i in range(n - 1)])
    from_next = ppermute(mesh, [s[:halo] for s in slabs], [(i + 1, i) for i in range(n - 1)])
    return [torch.cat([p, s, q]) for p, s, q in zip(from_prev, slabs, from_next)]


class HaloShardedOps:
    """Whole-volume ops sharded along axis 0 of a [D, H, W] volume over
    ``mesh``. ``map_overlap(fn, x, halo)`` is the general primitive; the
    named ops wrap ops/filters.py, ops/stats.py, ops/grid.py and
    ops/n4.py through it or through psum'd moments. Results land on the
    input's device."""

    def __init__(self, mesh: Mesh):
        if not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deepwmh_tpu_torch.parallel.mesh.Mesh, got %r"
                            % (mesh,))
        self.mesh = mesh
        self.n = mesh.size

    # -- sharding ------------------------------------------------------------

    def _scatter(self, x):
        """Equal row slabs of ``x`` (rows a multiple of n), shard d's on its
        device."""
        rows = x.shape[0] // self.n
        return [to_device(x[d * rows:(d + 1) * rows], dev)
                for d, dev in enumerate(self.mesh.devices)]

    @staticmethod
    def _gather(slabs, device):
        return torch.cat([to_device(s, device) for s in slabs])

    # -- core primitive ------------------------------------------------------

    def map_overlap(self, fn, x, halo: int, cache_key=None):
        """``fn`` ([rows + 2 * halo, H, W] -> same shape) on each
        halo-extended slab, halos cropped; returns the assembled [D, H, W].
        ``cache_key`` is accepted for the JAX signature (there it names a
        compiled program; nothing is compiled here)."""
        x = x.float()
        d0 = x.shape[0]
        xp, _ = _pad_rows(x, self.n)
        outs = []
        for ext in halo_pad_local(self.mesh, self._scatter(xp), halo):
            y = fn(ext)
            outs.append(y[halo:y.shape[0] - halo] if halo else y)
        return self._gather(outs, x.device)[:d0]

    # -- window filters (exact: ops/filters.py's zero boundary) --------------

    def _window_filter(self, fn_name: str, x, kernel_size):
        """One kernel-half halo along the sharded axis, the local op applied
        as it is (the 3x3x3 median: K2, one launch a slab)."""
        ks = filters._norm_ksize(kernel_size, x.dim())
        fn = getattr(filters, fn_name)
        return self.map_overlap(lambda v: fn(v, ks), x, halo=max(ks[0] // 2, 1),
                                cache_key=(fn_name, ks))

    def median_filter(self, x, kernel_size):
        return self._window_filter("median_filter", x, kernel_size)

    def mean_filter(self, x, kernel_size):
        return self._window_filter("mean_filter", x, kernel_size)

    def min_filter(self, x, kernel_size):
        return self._window_filter("min_filter", x, kernel_size)

    def max_filter(self, x, kernel_size):
        return self._window_filter("max_filter", x, kernel_size)

    # -- global statistics ---------------------------------------------------

    def z_score(self, x, mask=None):
        """Masked z-score with psum-merged moments (count clamped to 1,
        population std, floored at EPS_STD), as ops.stats.z_score."""
        x = x.float()
        d0 = x.shape[0]
        valid = torch.ones_like(x) if mask is None else (mask.float() > 0.5).float()
        xs = self._scatter(_pad_rows(x, self.n)[0])
        ws = self._scatter(_pad_rows(valid, self.n)[0])  # padded rows weigh 0
        s = psum(self.mesh, [(xl * wl).sum() for xl, wl in zip(xs, ws)])
        cnt = torch.clamp(psum(self.mesh, [wl.sum() for wl in ws]), min=1.0)
        mus = broadcast(self.mesh, s / cnt)
        var = psum(self.mesh, [(wl * (xl - mu) ** 2).sum()
                               for xl, wl, mu in zip(xs, ws, mus)]) / cnt
        stds = broadcast(self.mesh, torch.clamp(torch.sqrt(torch.clamp(var, min=0.0)),
                                                min=EPS_STD))
        outs = [(xl - mu) / sd for xl, mu, sd in zip(xs, mus, stds)]
        return self._gather(outs, x.device)[:d0]

    # -- mean_std_grid (stage-1's 50 mm alignment grid) ----------------------

    def mean_std_grid(self, data, patch_size, mask=None, order: int = 1):
        """ops.grid.mean_std_grid sharded: per-shard cell sums, the (small)
        cell grid all_gather'd and finished once, then each shard
        interpolates only its own output rows at global coordinates (axis 0
        first, then H and W, in the single-device order)."""
        data = data.float()
        shape = tuple(data.shape)
        p = [2 * int(math.ceil(s / 2)) for s in patch_size]
        step = [pi // 2 for pi in p]
        padded = [pi * int(math.ceil(sh / pi)) for pi, sh in zip(p, shape)]
        G0, G1, G2 = [padded[i] // step[i] for i in range(3)]
        s0, s1, s2 = step
        n = self.n
        cps = int(math.ceil(G0 / n))  # cells per shard along axis 0
        rows = cps * s0
        widths = (0, padded[2] - shape[2], 0, padded[1] - shape[1], 0, n * rows - shape[0])
        xs = self._scatter(F.pad(data, widths))
        if mask is not None:
            ms = self._scatter(F.pad((mask > 0.5).float(), widths))
            views = [(xl * ml).reshape(cps, s0, G1, s1, G2, s2) for xl, ml in zip(xs, ms)]
        else:
            views = [xl.reshape(cps, s0, G1, s1, G2, s2) for xl in xs]

        def gather(parts):
            return all_gather(self.mesh, parts).reshape(n * cps, G1, G2)[:G0]

        psum_ = gather([v.sum((1, 3, 5)) for v in views])
        psq = gather([torch.square(v).sum((1, 3, 5)) for v in views])
        if mask is not None:
            pcnt = gather([ml.reshape(cps, s0, G1, s1, G2, s2).sum((1, 3, 5)) for ml in ms])
        else:
            pcnt = torch.full((G0, G1, G2), float(s0 * s1 * s2), dtype=torch.float32,
                              device=psum_.device)
        for ax in range(3):
            psum_ = _shift_add(psum_, ax)
            psq = _shift_add(psq, ax)
            pcnt = _shift_add(pcnt, ax)
        cnt_safe = torch.clamp(pcnt, min=1.0)
        mu = psum_ / cnt_safe
        sigma = torch.sqrt(torch.clamp(psq / cnt_safe - torch.square(mu), min=0.0))
        if mask is not None:
            empty = pcnt < 0.5
            mu = torch.where(empty, 0.0, mu)
            sigma = torch.where(empty, 1e-5, sigma)
        else:
            sigma = torch.clamp(sigma, min=1e-5)

        n_in, n_up = G0 + 2, (G0 + 2) * s0
        resize = nearest_resize_axis if order == 0 else linear_resize_axis

        def upsample(grid):
            outs = []
            for d, g in enumerate(broadcast(self.mesh, F.pad(grid, (1, 1, 1, 1, 1, 1)))):
                # upsampled index of this shard's output rows (global)
                u = torch.arange(d * rows, (d + 1) * rows, device=g.device) + s0 // 2
                x = u.float() * ((n_in - 1) / max(n_up - 1, 1))
                if order == 0:
                    out = g.index_select(0, torch.floor(x + 0.5).long().clamp(0, n_in - 1))
                else:
                    lo = torch.floor(x).long().clamp(0, n_in - 2)
                    w = (x - lo.float()).view(-1, 1, 1)
                    out = g.index_select(0, lo) * (1 - w) + g.index_select(0, lo + 1) * w
                for ax, (Ga, sa, sh) in ((1, (G1, s1, shape[1])), (2, (G2, s2, shape[2]))):
                    out = resize(out, ax, (Ga + 2) * sa).narrow(ax, sa // 2, sh)
                outs.append(out)
            return self._gather(outs, data.device)[:shape[0]]

        return upsample(mu), upsample(sigma)

    # -- N4 bias correction --------------------------------------------------

    def n4_bias_correction(self, data, mask=None, shrink: int = 2, levels: int = 3,
                           iters_per_level: int = 50, base_control: int = 1,
                           return_bias: bool = False):
        """ops.n4.n4_bias_correction slab-sharded: every full- and
        working-resolution array lives in row slabs; the intensity range and
        the fixed-point histogram (int64, summed before the conversion to
        f32, so a run repeats bit for bit) and the control-cell sums are
        psum'd, the map from the histogram is computed once, each shard
        evaluates the B-spline field and the final upsample for its own
        rows at global coordinates (one neighbour row each side for the
        upsample), and the unit geometric mean is psum'd.

        The control lattice and the upsample endpoints follow the
        single-device extents, so depth padding moves neither. As in the
        JAX package, the histogram's quarter sample is taken per slab (the
        single-device one when each slab's working rows are even)."""
        data = data.float()
        shape = tuple(data.shape)
        mask_full = (data > 0).float() if mask is None else (mask > 0.5).float()
        n = self.n
        unit = n * shrink  # each slab's rows a multiple of shrink
        total_rows = int(math.ceil(shape[0] / unit) * unit)
        rows_full = total_rows // n
        rows_small = rows_full // shrink
        xs = self._scatter(_pad_rows(data, unit)[0])
        ms = self._scatter(_pad_rows(mask_full, unit)[0])
        # the lattice follows the single-device working depth; rows beyond
        # it are mask-0 padding and never contribute
        Ds_ref = -(-shape[0] // shrink)
        Hs, Ws = -(-shape[1] // shrink), -(-shape[2] // shrink)

        if shrink > 1:
            small = [_shrink(xl, shrink) for xl in xs]
            msm = [(_shrink(ml, shrink) > 0.5).float() for ml in ms]
        else:
            small, msm = xs, ms
        v0 = [torch.log(torch.clamp(s, min=1e-6)) * m for s, m in zip(small, msm)]
        pinv = torch.from_numpy(_cheb_pinv(NBINS, CHEB_K)).to(self.mesh.devices[0])
        grow = [torch.arange(d * rows_small, (d + 1) * rows_small, device=dev)
                for d, dev in enumerate(self.mesh.devices)]

        log_bias = [torch.zeros_like(v) for v in v0]
        for level in range(levels):
            n_c = tuple(min(base_control * (2**level) + 1, s) for s in (Ds_ref, Hs, Ws))
            for _ in range(iters_per_level):
                v = [a - b for a, b in zip(v0, log_bias)]
                e = self._sharpen(v, msm, pinv)
                residual = [(vl - el) * m for vl, el, m in zip(v, e, msm)]
                delta = self._smooth_field(residual, msm, n_c, grow, (Ds_ref, Hs, Ws))
                log_bias = [lb + dl for lb, dl in zip(log_bias, delta)]

        lb = self._upsample_rows(log_bias, rows_full, Ds_ref, shape[0])
        lb = [linear_resize_axis(linear_resize_axis(t, 1, shape[1]), 2, shape[2]) for t in lb]
        num = psum(self.mesh, [(t * ml).sum() for t, ml in zip(lb, ms)])
        den = torch.clamp(psum(self.mesh, [ml.sum() for ml in ms]), min=1.0)
        scales = broadcast(self.mesh, torch.exp(num / den))
        bias = [torch.exp(t) / sc for t, sc in zip(lb, scales)]
        corrected = [xl / torch.clamp(b, min=1e-6) for xl, b in zip(xs, bias)]
        corrected = self._gather(corrected, data.device)[:shape[0]]
        if return_bias:
            return corrected, self._gather(bias, data.device)[:shape[0]]
        return corrected

    def _sharpen(self, v, msm, pinv):
        """ops.n4._sharpen over the slabs: the range and the fixed-point
        histogram merged across shards, the map computed once."""
        ranges = [_intensity_range(vl, m) for vl, m in zip(v, msm)]
        vmin = all_gather(self.mesh, [r[0] for r in ranges]).min()
        vmax = all_gather(self.mesh, [r[1] for r in ranges]).max()
        width = _bin_width(vmin, vmax, NBINS)
        lims = broadcast(self.mesh, torch.stack([vmin, width]))
        pos = [_bin_positions(vl, lim[0], lim[1], NBINS) for vl, lim in zip(v, lims)]
        hist = psum(self.mesh, [_fixed_histogram(*_histogram_sample(p, m), NBINS)
                                for p, m in zip(pos, msm)])
        coef = _expectation_map(_from_fixed(hist, NBINS), vmin, width, pinv)
        return [_clenshaw(p, c) for p, c in zip(pos, broadcast(self.mesh, coef))]

    def _smooth_field(self, residual, msm, n_c, grow, small_shape):
        """ops.n4._smooth_field over the slabs: H/W cell sums per slab, rows
        folded into the global D cells by a one-hot product (no atomics),
        psum'd; each shard evaluates the cubic B-spline at its global rows
        (axis 0 first, then H and W, in the single-device order)."""
        Ds_ref, Hs, Ws = small_shape
        cs = [int(math.ceil(s / c)) for s, c in zip(small_shape, n_c)]
        pad = (0, cs[2] * n_c[2] - Ws, 0, cs[1] * n_c[1] - Hs)
        s_parts, c_parts = [], []
        for r, m, g in zip(residual, msm, grow):
            cells = (r.shape[0], n_c[1], cs[1], n_c[2], cs[2])
            r_hw = F.pad(r * m, pad).reshape(cells).sum(dim=(2, 4))
            m_hw = F.pad(m, pad).reshape(cells).sum(dim=(2, 4))
            cell = torch.clamp(g // cs[0], max=n_c[0] - 1)
            onehot = (cell[None, :] == torch.arange(n_c[0], device=g.device)[:, None]).float()
            s_parts.append((onehot @ r_hw.reshape(r.shape[0], -1)).view(n_c))
            c_parts.append((onehot @ m_hw.reshape(r.shape[0], -1)).view(n_c))
        ctrl = psum(self.mesh, s_parts) / torch.clamp(psum(self.mesh, c_parts), min=1.0)
        out = []
        for c, g in zip(broadcast(self.mesh, ctrl), grow):
            if n_c[0] == 1:
                f = c.expand(g.shape[0], n_c[1], n_c[2])
            else:
                x = g.float() * ((n_c[0] - 1) / max(Ds_ref - 1, 1))
                k = torch.floor(x).long().clamp(0, n_c[0] - 2)
                t = x - k.float()
                f = 0.0
                for w, d in zip(_cubic_bspline_weights(t), (-1, 0, 1, 2)):
                    f = f + w.view(-1, 1, 1) * c.index_select(0, (k + d).clamp(0, n_c[0] - 1))
            out.append(_bspline_upsample_axis(_bspline_upsample_axis(f, 1, Hs), 2, Ws))
        return out

    def _upsample_rows(self, small, rows_full, n_in, n_out):
        """Axis 0 of the working-resolution slabs resized linearly to each
        shard's full-resolution rows, endpoints aligned to the single-device
        (n_in -> n_out) resize. The support reaches one row past either
        slab edge, so each slab is extended by one row of each neighbour's
        (zeros at the volume's ends, which the index clamp never reads)."""
        if n_in == n_out:
            return small
        rows_small = small[0].shape[0]
        out = []
        for d, ext in enumerate(halo_pad_local(self.mesh, small, 1)):
            r = torch.arange(d * rows_full, (d + 1) * rows_full, device=ext.device)
            x = r.float() * ((n_in - 1) / max(n_out - 1, 1))
            lo = torch.floor(x).long().clamp(0, n_in - 2)
            w = (x - lo.float()).view(-1, 1, 1)
            loc = torch.clamp(lo - d * rows_small + 1, 0, rows_small)
            out.append(ext.index_select(0, loc) * (1 - w) + ext.index_select(0, loc + 1) * w)
        return out
