"""All-pairs group registration with idempotent artifacts (the port of
``deepwmh_tpu.registration.group``).

The reference's ANTsGroupRegistration wrapper: register every source
(healthy reference) onto every target (training subject), S x T pairs,
skipping pairs whose outputs already load cleanly and supporting the manual
multi-machine ``--distributed a/b`` round-robin sharding. Each pair is the
affine + SVF stack on one device.

Artifact layout per pair, the same as the JAX package's (either package
reads and resumes the other's):
  <out>/<s>_to_<t>.nii.gz          warped source image on the target grid
  <out>/<s>_to_<t>/warp.nii.gz     displacement field (D,H,W,3, voxels),
                                   int16 with a scl_slope
  <out>/<s>_to_<t>/affine.json     3x4 physical affine + spacings, written
                                   last: its presence marks a complete pair

The numbers pass through the same casts as there: fixed and moving are
uploaded as f16, the displacement and the warped image come back as f16.
``_pair_core_batch`` registers B same-geometry pairs stacked on a leading
axis through one Adam loop a level (the port of JAX's ``vmap`` of
``_pair_core``): every launch of a step serves the B pairs.
``launch(batch_pairs=B)`` buckets the remaining pairs by geometry and sends
chunks of B through it (a chunk of one through ``_pair_core``).
``register_pairs_mesh`` spreads a batch over a device mesh: shard d takes a
contiguous block and runs it as one batch on its device (a thread a
distinct card); ``launch(mesh=)`` sends each chunk through it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import atomic_write_json, join_path, load_json, mkdir
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.parallel.mesh import barrier, map_blocks
from deepwmh_tpu_torch.registration.affine import (
    AffineConfig,
    _affine_core,
    feasible_affine_cfg,
    resample_moving,
    spacing_tensor,
)
from deepwmh_tpu_torch.registration.svf import (
    SVFConfig,
    _feasible_cfg,
    _svf_core,
    apply_affine_svf,
)

def pair_name(source_case: str, target_case: str) -> str:
    return "%s_to_%s" % (source_case, target_case)


def _pair_core(fixed, moving, fsp, msp, acfg, scfg, deformable):
    """One pair on the device: affine pyramid -> resample -> SVF pyramid ->
    final fused [affine, warp] resample. Returns (matrix, affine loss,
    disp f16 or None, SVF loss or None, warped f16) as device tensors; for
    a batch [B,D,H,W] (``_pair_core_batch``) each with a leading B.
    The inputs are made C-ordered first: the loops' sums follow the memory
    order, and equal values must give an equal pair whatever the layout."""
    fixed = fixed.float().contiguous()
    moving = moving.float().contiguous()
    shape = tuple(fixed.shape[-3:])
    mat, aff_loss = _affine_core(fixed, moving, fsp, msp, acfg)
    moving_on_fixed = resample_moving(moving, mat, shape, fsp, msp, order=1)
    if deformable:
        disp, svf_loss = _svf_core(fixed, moving_on_fixed, scfg)
        warped = apply_affine_svf(moving, mat, disp, shape, fsp, msp, order=1)
        disp16 = disp.half()
    else:
        disp16, svf_loss = None, None
        warped = moving_on_fixed
    return mat, aff_loss, disp16, svf_loss, warped.half()


def _pair_core_batch(fixed, moving, fsp, msp, acfg, scfg, deformable):
    """B same-geometry pairs [B,D,H,W] with shared spacings through one
    Adam loop a level. Returns JAX's tuple layout with a leading B: (mats
    [B,3,4], affine losses [B], disp16 [B,3,D,H,W] or None, SVF losses [B]
    or None, warped16 [B,D,H,W]), device tensors. The configs are one
    pair's (``feasible_*`` of [D,H,W])."""
    if fixed.dim() != 4 or moving.dim() != 4 or fixed.shape[0] != moving.shape[0]:
        raise ValueError("_pair_core_batch: need fixed and moving stacks [B, D, H, W] of B pairs "
                         "(got %s and %s)" % (tuple(fixed.shape), tuple(moving.shape)))
    return _pair_core(fixed, moving, fsp, msp, acfg, scfg, deformable)


def _to_host(outs):
    """A pair's device outputs as numpy / floats (the one wait per pair); a
    batch's as numpy arrays with the leading B."""
    mat, aff_loss, disp16, svf_loss, warped16 = outs
    loss = float if aff_loss.dim() == 0 else (lambda t: t.cpu().numpy())
    return (mat.cpu().numpy(), loss(aff_loss),
            None if disp16 is None else disp16.cpu().numpy(),
            None if svf_loss is None else loss(svf_loss), warped16.cpu().numpy())


def _run_block(fixed16, moving16, fsp, msp, acfg, scfg, deformable, dev):
    """A block of R same-geometry pairs (f16 host stacks [R,D,H,W]) on
    ``dev``: one pair through ``_pair_core``, more as one
    ``_pair_core_batch``. Returns host outputs with the leading R."""
    fixed = torch.from_numpy(np.ascontiguousarray(fixed16)).to(dev)
    moving = torch.from_numpy(np.ascontiguousarray(moving16)).to(dev)
    if fixed.shape[0] > 1:
        return _to_host(_pair_core_batch(fixed, moving, fsp, msp, acfg, scfg, deformable))
    outs = _to_host(_pair_core(fixed[0], moving[0], fsp, msp, acfg, scfg, deformable))
    return tuple(None if o is None else np.asarray(o, np.float32 if np.ndim(o) == 0 else None)[None]
                 for o in outs)


def register_pairs_mesh(fixed_stack, moving_stack, fixed_spacing, moving_spacing, mesh,
                        affine_cfg=None, svf_cfg=None, deformable=True):
    """Data-parallel pair registration over a ``parallel.mesh.Mesh``: the
    [B, D, H, W] stacks (cast to f16, as uploaded) are padded to a multiple
    of the mesh size by repeating the last pair, shard d takes a contiguous
    block of rows and runs it as one ``_pair_core_batch`` on its device (a
    block of one through ``_pair_core``), a thread a distinct device; the
    padding is dropped. On a mesh across processes each process registers
    its own shards' blocks and the outputs are gathered, so every process
    returns all B rows. Returns JAX's tuple layout on the host: (mats
    [B,3,4], affine losses [B], disp16 [B,3,D,H,W] or None, SVF losses [B]
    or None, warped16 [B,D,H,W])."""
    shape = tuple(np.shape(fixed_stack)[1:])
    acfg = feasible_affine_cfg(affine_cfg or AffineConfig(), shape)
    scfg = _feasible_cfg(svf_cfg or SVFConfig(), shape)

    def run(dev, fixed16, moving16):
        return _run_block(fixed16, moving16, spacing_tensor(fixed_spacing, dev),
                          spacing_tensor(moving_spacing, dev), acfg, scfg, deformable, dev)

    stacks = [torch.from_numpy(np.ascontiguousarray(a, np.float16))
              for a in (fixed_stack, moving_stack)]
    return tuple(None if o is None else o.numpy() for o in map_blocks(mesh, stacks, run))


class GroupRegistration:
    def __init__(self, sources, targets, output_folder, keep_deformation: bool = True,
                 quick: bool = False, large_deformation: bool = False,
                 distributed: str = None, deformable: bool = True,
                 warm_start: bool = False, device=None):
        """sources/targets: [(case_name, image_path)].

        quick: the reference's --allow-quick-registration (the finest
        pyramid level dropped); large_deformation: --allow-large-deformations
        (more iterations, 2^4 integration steps, the exact-gradient polish);
        both together are the training-prep preset. distributed: 'a/b' runs
        shard a (1-based) of b. warm_start: register the first source onto
        every target and the other sources onto the first at full budget,
        then seed every other pair from their composition on a shortened
        schedule (registration/warm.py); needs >= 2 sources, deformable
        pairs with kept warps, and no sharding. device: CUDA unless the CPU
        is asked for.
        """
        self.sources = list(sources)
        self.targets = list(targets)
        self.device = resolve_device(device)
        self.output_folder = mkdir(output_folder)
        self.keep_deformation = keep_deformation
        self.deformable = deformable
        self._quick = quick
        self._large = large_deformation
        self.warm_start = bool(warm_start) and len(self.sources) >= 2
        if warm_start and distributed:
            raise ValueError("warm_start shards have cross-pair dependencies (anchor row "
                             "first); use --distributed without --svf-warm-start")
        if warm_start and not (deformable and keep_deformation):
            raise ValueError("warm_start needs deformable pairs with kept warps (the "
                             "composed seed reads the anchor row's warp fields)")

        if quick and large_deformation:
            # the reference's training-prep configuration: large-deformation
            # capacity (iterations, 2^4 integration steps, the hybrid
            # exact-polish exp gradient) on the quick pyramid
            self.affine_cfg = AffineConfig(shrinks=(8, 4), iters=(200, 120))
            self.svf_cfg = SVFConfig(shrinks=(8, 4), iters=(200, 160), n_squaring=4,
                                     exact_polish_iters=30)
        elif quick:
            self.affine_cfg = AffineConfig(shrinks=(8, 4), iters=(100, 50))
            self.svf_cfg = SVFConfig(shrinks=(8, 4), iters=(100, 50))
        elif large_deformation:
            self.affine_cfg = AffineConfig(shrinks=(8, 4, 2), iters=(200, 120, 60))
            self.svf_cfg = SVFConfig(shrinks=(8, 4, 2), iters=(200, 160, 80), n_squaring=4,
                                     exact_polish_iters=30)
        else:
            self.affine_cfg = AffineConfig()
            self.svf_cfg = SVFConfig()

        tasks = [(s, t) for s in self.sources for t in self.targets]
        if distributed:
            a, b = (int(v) for v in distributed.split("/"))
            if not 1 <= a <= b:
                raise ValueError("invalid --distributed %s" % distributed)
            tasks = [task for i, task in enumerate(tasks) if i % b == (a - 1)]
        self.tasks = tasks

    # ------------------------------------------------------------------ #

    def _pair_paths(self, s_case, t_case):
        name = pair_name(s_case, t_case)
        return {
            "image": join_path(self.output_folder, name + ".nii.gz"),
            "dir": join_path(self.output_folder, name),
            "affine": join_path(self.output_folder, name, "affine.json"),
            "warp": join_path(self.output_folder, name, "warp.nii.gz"),
        }

    def _pair_done(self, paths) -> bool:
        if not nifti.try_load_nifti(paths["image"]):
            return False
        if not os.path.isfile(paths["affine"]):
            return False
        if self.deformable and self.keep_deformation and not nifti.try_load_nifti(paths["warp"]):
            return False
        return True

    def pair_complete(self, s_case: str, t_case: str) -> bool:
        """Full completeness probe of one pair (image + affine + warp when
        kept): the contract distributed barriers use."""
        return self._pair_done(self._pair_paths(s_case, t_case))

    def _pair_cfgs(self, fixed_shape):
        return (feasible_affine_cfg(self.affine_cfg, fixed_shape),
                _feasible_cfg(self.svf_cfg, fixed_shape))

    def _pair_meta(self, matrix, f_sp, m_sp, f_shape, aff_loss, svf_loss):
        return {
            "matrix": np.asarray(matrix).tolist(),
            "fixed_spacing": [float(v) for v in f_sp],
            "moving_spacing": [float(v) for v in m_sp],
            "fixed_shape": [int(v) for v in f_shape],
            "affine_loss": float(aff_loss),
            "svf_loss": None if svf_loss is None else float(svf_loss),
            "deformable": bool(self.deformable),
            "warp_kept": bool(self.deformable and self.keep_deformation),
        }

    def _write_pair(self, paths, f_hdr, f_sp, m_sp, f_shape,
                    matrix, aff_loss, disp16, svf_loss, warped16):
        mkdir(paths["dir"])
        nifti.save_nifti(np.asarray(warped16, np.float32), f_hdr, paths["image"], level=2)
        if disp16 is not None and self.keep_deformation:
            nifti.save_nifti_scaled_int16(np.moveaxis(np.asarray(disp16, np.float32), 0, -1),
                                          f_hdr, paths["warp"])
        # affine.json last: the cheap atomic marker whose presence implies
        # the image (and the warp, when kept) are complete
        atomic_write_json(self._pair_meta(matrix, f_sp, m_sp, f_shape, aff_loss, svf_loss),
                          paths["affine"])

    def _run_chunk(self, fixed16, moving16, f_sp, m_sp, acfg, scfg):
        """A chunk of same-geometry pairs (f16 host stacks) on the
        registration's device -> host outputs with the leading chunk axis."""
        dev = self.device
        return _run_block(fixed16, moving16, spacing_tensor(f_sp, dev),
                          spacing_tensor(m_sp, dev), acfg, scfg, self.deformable, dev)

    def register_pair(self, s_case, s_path, t_case, t_path, verbose=True):
        paths = self._pair_paths(s_case, t_case)
        if self._pair_done(paths):
            if verbose:
                print("pair %s: already done, skip" % pair_name(s_case, t_case))
            return paths
        if verbose:
            print("registering %s" % pair_name(s_case, t_case), flush=True)
        fixed, f_hdr = nifti.load_nifti(t_path)
        moving, _ = nifti.load_nifti(s_path)
        f_sp = nifti.get_nifti_pixdim(t_path)
        m_sp = nifti.get_nifti_pixdim(s_path)
        acfg, scfg = self._pair_cfgs(fixed.shape)
        # f16 upload: FLAIR intensities carry <= 12 significant bits
        out = self._run_chunk(fixed.astype(np.float16)[None], moving.astype(np.float16)[None],
                              f_sp, m_sp, acfg, scfg)
        self._write_pair(paths, f_hdr, f_sp, m_sp, fixed.shape,
                         *(None if o is None else o[0] for o in out))
        return paths

    def launch(self, verbose: bool = True, batch_pairs: int = 1, mesh=None):
        """Register every remaining pair as a three-stage pipeline: threaded
        NIfTI prefetch -> the chunk on the device -> threaded artifact
        writes. The remaining pairs are bucketed by geometry (shapes and
        spacings) and cut into chunks of ``batch_pairs``: without ``mesh`` a
        chunk of one runs through ``_pair_core`` and a longer one as one
        ``_pair_core_batch``; with ``mesh`` every chunk goes through
        ``register_pairs_mesh`` (``batch_pairs`` should be at least the mesh
        size to keep every shard busy). Across processes every process
        writes only its own shards' pairs, then waits for the others."""
        if self.warm_start:
            if mesh is not None or batch_pairs > 1:
                raise ValueError("warm_start is a single-chip serial schedule (anchor row -> warm "
                                 "rows); drop --svf-warm-start to batch/shard pairs")
            return self._launch_warm(verbose=verbose)
        return self._launch_batched(max(1, int(batch_pairs)), mesh, verbose=verbose)

    def _launch_batched(self, batch_pairs: int, mesh, verbose: bool = True):
        if mesh is not None:
            barrier(mesh)  # every process sees the same pairs to do
        buckets, n_skip = {}, 0
        for s, t in self.tasks:
            if self._pair_done(self._pair_paths(s[0], t[0])):
                n_skip += 1
                continue
            f_hdr = nifti.get_nifti_header(t[1])
            m_hdr = nifti.get_nifti_header(s[1])
            # the spacings the JAX launcher groups pairs by, and writes:
            # abs() of the header zooms rounded to 4 decimals
            key = (tuple(f_hdr.shape[:3]), tuple(m_hdr.shape[:3]),
                   tuple(round(abs(z), 4) for z in f_hdr.zooms[:3]),
                   tuple(round(abs(z), 4) for z in m_hdr.zooms[:3]))
            buckets.setdefault(key, []).append((s, t))
        if verbose and n_skip:
            print("%d pair(s) already done, skipped" % n_skip, flush=True)
        chunks = [(pairs[i:i + batch_pairs], f_shape, f_sp, m_sp)
                  for (f_shape, _, f_sp, m_sp), pairs in buckets.items()
                  for i in range(0, len(pairs), batch_pairs)]

        def load(chunk):
            # gzip decompression releases the GIL; f16 for the upload
            return (np.stack([nifti.load_nifti_simple(t[1]) for _, t in chunk]).astype(np.float16),
                    np.stack([nifti.load_nifti_simple(s[1]) for s, _ in chunk]).astype(np.float16))

        done, total, writes = 0, sum(len(c[0]) for c in chunks), []
        with ThreadPoolExecutor(max_workers=8) as pool:
            pending = pool.submit(load, chunks[0][0]) if chunks else None
            for ci, (chunk, f_shape, f_sp, m_sp) in enumerate(chunks):
                fixed, moving = pending.result()
                if ci + 1 < len(chunks):
                    pending = pool.submit(load, chunks[ci + 1][0])
                done += len(chunk)
                if verbose:
                    names = [pair_name(s[0], t[0]) for s, t in chunk]
                    print("[%d/%d] registering %s"
                          % (done, total, names[0] if len(names) == 1 else names), flush=True)
                acfg, scfg = self._pair_cfgs(f_shape)
                if mesh is None:
                    outs, rows, mine = self._run_chunk(fixed, moving, f_sp, m_sp, acfg, scfg), \
                        len(chunk), (0,)
                else:
                    outs = register_pairs_mesh(fixed, moving, f_sp, m_sp, mesh, affine_cfg=acfg,
                                               svf_cfg=scfg, deformable=self.deformable)
                    rows, mine = -(-len(chunk) // mesh.size), mesh.local_shards
                for j, (s, t) in enumerate(chunk):
                    if j // rows not in mine:
                        continue  # another process's pair
                    outs_j = tuple(None if o is None else o[j] for o in outs)
                    writes.append(pool.submit(self._write_pair, self._pair_paths(s[0], t[0]),
                                              nifti.get_nifti_header(t[1]), f_sp, m_sp,
                                              f_shape, *outs_j))
                writes = _reap(writes)
            # launch() returns only when every artifact is written
            for f in writes:
                f.result()
        if mesh is not None:
            barrier(mesh)

    def _launch_warm(self, verbose: bool = True):
        """The anchor source's row and the source -> anchor auxiliary pairs
        at the full budget (under ``_warm_aux/``, not part of the S x T
        contract), then every remaining pair seeded from their composition
        on the shortened schedule. Same artifacts and probes as the cold
        path, so resume works across the two."""
        from deepwmh_tpu_torch.registration.warm import warm_pair_core, warm_schedule

        anchor, others = self.sources[0], self.sources[1:]
        aux_dir = join_path(self.output_folder, "_warm_aux")
        GroupRegistration(others, [anchor], aux_dir, keep_deformation=True,
                          quick=self._quick, large_deformation=self._large,
                          device=self.device).launch(verbose=verbose)
        GroupRegistration([anchor], self.targets, self.output_folder, keep_deformation=True,
                          quick=self._quick, large_deformation=self._large,
                          device=self.device).launch(verbose=verbose)

        remaining = [(s, t) for s in others for t in self.targets
                     if not self._pair_done(self._pair_paths(s[0], t[0]))]
        if not remaining:
            if verbose:
                print("all warm pairs already done", flush=True)
            return

        dev = self.device

        def field(pdir):
            """(matrix, warp [3,D,H,W] f16) of a finished pair, on the device."""
            meta = load_json(join_path(pdir, "affine.json"))
            warp = np.moveaxis(nifti.load_nifti_simple(join_path(pdir, "warp.nii.gz")), -1, 0)
            return (torch.as_tensor(np.asarray(meta["matrix"], np.float32)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(warp.astype(np.float16))).to(dev))

        sp_s0 = spacing_tensor(nifti.get_nifti_pixdim(anchor[1]), dev)
        aux = {s_name: field(join_path(aux_dir, pair_name(s_name, anchor[0])))
               for s_name, _ in others}
        moving_by_src = {s_name: torch.from_numpy(
            nifti.load_nifti_simple(path).astype(np.float16)).to(dev) for s_name, path in others}

        def load_target(t):
            return (nifti.load_nifti_simple(t[1]).astype(np.float16),
                    field(join_path(self.output_folder, pair_name(anchor[0], t[0]))))

        by_target = {}
        for s, t in remaining:
            by_target.setdefault(t, []).append(s)
        targets_todo = list(by_target)

        done, total, writes = 0, len(remaining), []
        with ThreadPoolExecutor(max_workers=8) as pool:
            pending = pool.submit(load_target, targets_todo[0])
            for ti, t in enumerate(targets_todo):
                t_name, t_path = t
                fixed, (mat0t, d0t) = pending.result()
                if ti + 1 < len(targets_todo):
                    pending = pool.submit(load_target, targets_todo[ti + 1])
                f_hdr = nifti.get_nifti_header(t_path)
                f_sp = nifti.get_nifti_pixdim(t_path)
                acfg, scfg = self._pair_cfgs(fixed.shape)
                warm_scfg = warm_schedule(scfg)
                fx = torch.from_numpy(fixed).to(dev)
                fsp = spacing_tensor(f_sp, dev)
                for s_name, s_path in by_target[t]:
                    done += 1
                    if verbose:
                        print("[warm %d/%d] registering %s"
                              % (done, total, pair_name(s_name, t_name)), flush=True)
                    mati0, di0 = aux[s_name]
                    m_sp = nifti.get_nifti_pixdim(s_path)
                    outs = _to_host(warm_pair_core(
                        fx, moving_by_src[s_name], fsp, spacing_tensor(m_sp, dev), d0t, di0,
                        mat0t, mati0, sp_s0, acfg, warm_scfg))
                    writes.append(pool.submit(self._write_pair, self._pair_paths(s_name, t_name),
                                              f_hdr, f_sp, m_sp, fixed.shape, *outs))
                    writes = _reap(writes)
            for f in writes:
                f.result()


def _reap(futures):
    """Raise the error of any finished write (fail fast); keep the rest."""
    for f in futures:
        if f.done():
            f.result()
    return [f for f in futures if not f.done()]


def apply_pair_transforms(pair_dir, in_files, out_files, interp="NearestNeighbor",
                          device=None):
    """Warp files from the source subject's grid onto the target grid through
    a saved pair transform (the reference's two-step antsApplyTransforms
    label propagation) in one gather. Reads either package's pair
    directories; ``device``: CUDA unless the CPU is asked for."""
    dev = resolve_device(device)
    meta = load_json(join_path(pair_dir, "affine.json"))
    matrix = np.asarray(meta["matrix"], np.float32)
    fixed_shape = tuple(meta["fixed_shape"])
    f_sp, m_sp = meta["fixed_spacing"], meta["moving_spacing"]
    order = 0 if interp == "NearestNeighbor" else 1

    deformable = meta.get("deformable")
    if deformable is None:  # metas from older runs lack the explicit flag
        deformable = meta.get("warp_kept", meta.get("svf_loss") is not None)
    disp = None
    try:  # one decode (a probe-then-load would gunzip the field twice)
        disp = np.moveaxis(nifti.load_nifti_simple(join_path(pair_dir, "warp.nii.gz")), -1, 0)
    except Exception:
        pass
    if disp is None and deformable:
        # the pair image is SVF-warped: affine-only labels would be
        # misaligned with it and cached by the resume probes downstream
        raise RuntimeError(
            "pair %s: the pair was registered deformably but warp.nii.gz is missing or "
            "unreadable (never kept - re-run with keep_deformation - or deleted/corrupt: "
            "delete %s and re-run registration for this pair)." % (pair_dir, pair_dir))
    if disp is None:  # affine-only registration: zero displacement is exact
        disp = np.zeros((3,) + fixed_shape, np.float32)

    # donor header: the pair's registered image carries the target geometry
    pair_image = pair_dir.rstrip("/\\") + ".nii.gz"
    if os.path.isfile(pair_image):
        hdr = nifti.get_nifti_header(pair_image)
    else:
        hdr = nifti.NiftiHeader()
        hdr.set_shape(fixed_shape)
        hdr.set_zooms(tuple(f_sp))
        hdr.srow = np.concatenate([np.diag([f_sp[0], f_sp[1], f_sp[2]]), np.zeros((3, 1))],
                                  axis=1)

    disp_t = None
    for in_file, out_file in zip(in_files, out_files):
        if nifti.try_load_nifti(out_file):
            continue
        if disp_t is None:
            disp_t = torch.from_numpy(np.ascontiguousarray(disp, np.float32)).to(dev)
        data = torch.from_numpy(nifti.load_nifti_simple(in_file)).to(dev)
        out = apply_affine_svf(data, matrix, disp_t, fixed_shape, f_sp, m_sp, order=order)
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        nifti.save_nifti(out.cpu().numpy(), hdr, out_file)
