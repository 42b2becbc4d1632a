"""Stage-1 lesion analysis: the NLL anomaly pipeline (port of
``deepwmh_tpu.pipeline.analysis``).

Per case, on one device:

  rough brain mask from the registered label1 cohort -> z-score -> Otsu
  valid mask -> tissue-min background fill -> 50 mm local-mean alignment of
  every reference to the target -> voxelwise Gaussian NLL with a one-sided
  prior -> per-slice component filtering -> per-reference anomaly
  histograms -> zero-crossing auto-threshold -> cerebellum/brainstem 3 mm
  median (K2 at a 3x3x3 kernel) -> majority-vote tissue masking.

``nll_analysis_core`` takes one case or a batch of same-geometry cases on a
leading axis (``nll_analysis_batch``, the port of JAX's ``vmap`` of the
core): every stage runs over the case axis at once, each case with its own
statistics, bins and threshold, and K2 filters the batch in one launch.

``LesionAnalyzer`` handles the NIfTI I/O, the idempotent artifacts and the
per-case summary, with the JAX package's output contract (anomaly_score /
valid_mask / normalized_input / averaged_label / preprocessed_image /
segmentation[_pp] / summary.json + segmentation.txt). ``batch_cases`` runs
same-geometry chunks as batches; over a device mesh
(``analyze_and_do_segmentation(mesh=)``) a chunk's batch is split into a
block of cases a shard, each block one batch on its shard's device.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import atomic_write_json, join_path, mkdir
from deepwmh_tpu_torch.device import resolve_device
from deepwmh_tpu_torch.ops.components import (
    average_contiguous_labels,
    component_filtering,
    remove_3mm_sparks,
)
from deepwmh_tpu_torch.ops.filters import median_3mm
from deepwmh_tpu_torch.ops.grid import mean_std_grid
from deepwmh_tpu_torch.ops.histogram import (
    auto_threshold_from_curves,
    histogram_analysis,
    otsu_threshold,
)
from deepwmh_tpu_torch.ops.nll import nll, nll_from_moments
from deepwmh_tpu_torch.ops.stats import SPATIAL, group_mean, z_score
from deepwmh_tpu_torch.parallel.mesh import Mesh, map_blocks
from deepwmh_tpu_torch.utils.logging import SimpleTxtLog
from deepwmh_tpu_torch.utils.parallel import run_parallel
from deepwmh_tpu_torch.utils.profiling import span

PHYSICAL_PATCH_MM = 50.0
MIN_STD = 0.03


@dataclass
class AnalysisResult:
    anomaly: np.ndarray
    valid_mask: np.ndarray
    normalized_input: np.ndarray
    averaged_label: np.ndarray
    curve_x: np.ndarray
    curve_y: np.ndarray
    curve_r: np.ndarray
    curve_rs: np.ndarray
    threshold: float
    debug: dict = None  # intermediates when analysed with debug=True


def _fill_background(t, m_rough):
    """Voxels outside the rough brain take the tissue minimum (each
    volume's own; ``m_rough`` broadcasts against ``t``)."""
    tissue_min = torch.where(m_rough > 0.5, t, torch.inf).amin(SPATIAL, keepdim=True)
    return torch.where(m_rough < 0.5, tissue_min, t)


@torch.inference_mode()
def nll_analysis_core(
    x_raw,
    refs_raw,
    label1s,
    label2s,
    patch_size,
    voxel_size,
    num_label_classes,
    side="+",
    apply_otsu=True,
    mean_correction=True,
    debug=False,
):
    """x_raw [D, H, W]; refs_raw / label1s / label2s [K, D, H, W], all on
    one device and registered to the target; or a batch of B same-geometry
    cases, x_raw [B, D, H, W] and the cohorts [B, K, D, H, W].

    Returns (anomaly, valid_mask, normalized_input, averaged_label, curve_x,
    curve_y, curve_r, curve_rs, threshold), tensors on that device (each
    with a leading B for a batch). With debug=True a dict of intermediates
    is appended: the per-voxel intensity threshold back-solved from the
    anomaly threshold, the rough brain mask, the local mean, the cohort
    mean and std, and the aligned references with their anomaly maps. Each
    of the seven stages is a span, ``stage1.<stage>`` (``utils/profiling``).

    In a batch every statistic is a case's own: the K axis is the fourth
    from the end, minima, moments, bins and thresholds are taken over each
    volume's spatial axes, and the component filtering labels the B cases
    together as further slices (``component_filtering``)."""
    K = refs_raw.shape[-4]

    def stage(name):
        return span("stage1." + name)

    with stage("mask_zscore_otsu"):
        # rough brain mask: the cohort's label1 majority
        m_rough = (group_mean((label1s > 0.5).float()) > 0.5).float()
        m_cohort = m_rough.unsqueeze(-4)  # against a [..., K, D, H, W] stack
        x = z_score(x_raw.float(), mask=m_rough)
        if apply_otsu:
            x_min = x.amin(SPATIAL, keepdim=True)
            otsu_thr = otsu_threshold(torch.where(m_rough < 0.5, x_min, x))
            m_otsu = (x > otsu_thr[..., None, None, None]).float()
        else:
            m_otsu = torch.ones_like(x)
        m_valid = m_rough * m_otsu
        x = _fill_background(x, m_rough)
        refs = _fill_background(z_score(refs_raw.float(), mask=m_cohort), m_cohort)

    with stage("local_mean_alignment"):
        x_mu, _ = mean_std_grid(x, patch_size, mask=m_valid)
        if mean_correction:
            refs = (refs - mean_std_grid(refs, patch_size,
                                         mask=m_valid.unsqueeze(-4).expand_as(refs))[0]
                    + x_mu.unsqueeze(-4))

    with stage("nll"):
        # the target and every reference, each scored against the full cohort
        anomaly, x_mean, x_std = nll(x, refs, min_std=MIN_STD, side=side, return_all=True)
        anomaly_refs = (nll_from_moments(refs, x_mean.unsqueeze(-4), x_std.unsqueeze(-4), side)
                        * m_valid.unsqueeze(-4))

    with stage("component_filtering"):
        anomaly = anomaly * component_filtering(m_valid, voxel_size)

    with stage("histogram_threshold"):
        curve_x, curve_y, curve_r, curve_rs = histogram_analysis(anomaly, anomaly_refs, m_valid)
        threshold = auto_threshold_from_curves(curve_x, curve_rs)

    with stage("tissue_vote"):
        avg_label = average_contiguous_labels(label2s, num_label_classes).float()
        anomaly = anomaly * (avg_label > 0.5).float()
        cb_mask = (avg_label > 1.5) & (avg_label < 2.5)
        tissue_majority = ((label2s > 0.5).float().sum(-4) > K / 2.0).float()

    with stage("median_3mm"):
        # the cerebellum / brainstem median spliced in, then the vote's mask
        anomaly_cb = median_3mm(anomaly, voxel_size)
        anomaly = torch.where(cb_mask, anomaly_cb, anomaly) * tissue_majority

    base = (anomaly, m_valid, x, avg_label, curve_x, curve_y, curve_r, curve_rs, threshold)
    if not debug:
        return base
    # thr = (t - mu)^2 / (2 sigma^2) + log(sigma * 2.506) solved for t on the
    # '+' side; a negative discriminant gives NaN (no intensity reaches it)
    d = 2.0 * (threshold[..., None, None, None] - torch.log(x_std * 2.506))
    x_thr = x_mean + x_std * torch.sqrt(torch.where(d < 0, torch.nan, d))
    dbg = {
        "intensity_thr": x_thr * m_valid,
        "rough_brain": m_rough,
        "local_mean": x_mu,
        "mean_value": x_mean,
        "std_value": x_std * m_valid,
        "ref_aligned": refs,
        "ref_anomaly": anomaly_refs,
    }
    return base + (dbg,)


def nll_analysis_batch(xs, refs, l1s, l2s, *, patch_size, voxel_size, num_label_classes,
                       side="+", apply_otsu=True, mean_correction=True, mesh=None, device=None):
    """Stage-1 for a batch of same-geometry cases, JAX's
    ``nll_analysis_batch``: xs [B, D, H, W]; refs / l1s / l2s [B, K, D, H,
    W]. Returns ``nll_analysis_core``'s tuple with a leading B.

    Without ``mesh`` the batch runs as one ``nll_analysis_core`` call on the
    inputs' device (host arrays go to ``device``: CUDA unless the CPU is
    asked for). With ``mesh`` (a ``parallel.mesh.Mesh``) the batch is
    padded to a multiple of the mesh size by repeating the last case, shard
    d runs its contiguous block of cases as one batch on its device (a
    block of one as the one-case core; ``parallel.mesh.map_blocks``), the
    blocks are gathered in shard order on the host and the padding
    dropped. ``num_label_classes`` is the batch's: cases that disagree are
    split by the caller."""
    shapes = [tuple(np.shape(a)) for a in (xs, refs, l1s, l2s)]
    if (len(shapes[0]) != 4 or any(len(s) != 5 for s in shapes[1:])
            or len({s[:1] + s[2:] for s in shapes[1:]} | {shapes[0]}) != 1
            or len({s[1] for s in shapes[1:]}) != 1):
        raise ValueError("nll_analysis_batch: need xs [B, D, H, W] and refs / l1s / l2s "
                         "[B, K, D, H, W] of one geometry (got %s)" % (shapes,))
    kw = dict(patch_size=patch_size, voxel_size=voxel_size,
              num_label_classes=num_label_classes, side=side, apply_otsu=apply_otsu,
              mean_correction=mean_correction)

    def upload(a, dev):
        if torch.is_tensor(a):
            return a.to(dev)
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    if mesh is None:
        dev = xs.device if torch.is_tensor(xs) else resolve_device(device)
        return nll_analysis_core(*(upload(a, dev) for a in (xs, refs, l1s, l2s)), **kw)
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a deepwmh_tpu_torch.parallel.mesh.Mesh, got %r" % (mesh,))

    def run(dev, *block):
        block = [a.to(dev) for a in block]
        if block[0].shape[0] == 1:  # the one-case core, whose bits a case alone gets
            return [o.cpu()[None] for o in nll_analysis_core(*(a[0] for a in block), **kw)]
        return [o.cpu() for o in nll_analysis_core(*block, **kw)]

    cpu = torch.device("cpu")
    return map_blocks(mesh, [upload(a, cpu) for a in (xs, refs, l1s, l2s)], run)


def patch_size_from_voxel(voxel_size):
    """ceil(50 mm / pixdim) per axis."""
    return tuple(int(math.ceil(PHYSICAL_PATCH_MM / float(v))) for v in voxel_size)


@span("stage1.to_host")
def _numpy(t):
    return t.cpu().numpy()


@span("stage1.label_count")
def _label_count(label2s) -> int:
    """The label classes of a case's label2 stack (its largest id + 1)."""
    return int(np.max(label2s.astype(np.int64))) + 1


class LesionAnalyzer:
    """Host orchestration: NIfTI in, idempotent artifacts out. Runs on
    CUDA unless ``device="cpu"`` is asked for (``resolve_device``)."""

    def __init__(self, output_folder: str, logger: SimpleTxtLog = None, device=None):
        self.device = resolve_device(device)
        self.output_folder = mkdir(output_folder)
        self.data_dict = {}
        self.logger = logger

    def log(self, msg):
        if self.logger is not None:
            self.logger.write(msg)
        print(msg, flush=True)

    def add_case(self, name, x_input, x_refs, label1, label2):
        self.data_dict[name] = {"x": x_input, "r": x_refs, "m": label1, "y": label2}

    # ------------------------------------------------------------------ #

    def _load_case(self, case: str):
        """Host I/O for one case: the input and the K reference / label
        volumes, read in threads."""
        info = self.data_dict[case]
        x_raw, hdr = nifti.load_nifti(info["x"])
        voxel_size = tuple(round(v, 4) for v in nifti.get_nifti_pixdim(info["x"]))
        nr, nm = len(info["r"]), len(info["m"])
        paths = list(info["r"]) + list(info["m"]) + list(info["y"])
        vols = run_parallel(nifti.load_nifti_simple, paths, show_progress=False)
        refs = np.stack(vols[:nr])
        l1 = np.stack(vols[nr:nr + nm])
        l2 = np.stack(vols[nr + nm:])
        return x_raw, hdr, voxel_size, refs, l1, l2

    def analyze_case(self, case: str, intensity_prior="+", apply_otsu=True,
                     loaded=None, debug=False, device=None):
        """Returns (AnalysisResult, header, voxel size). ``device``: where
        the case runs (the analyzer's device by default; a mesh shard's)."""
        x_raw, hdr, voxel_size, refs, l1, l2 = loaded or self._load_case(case)
        num_classes = _label_count(l2)
        device = self.device if device is None else device

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

        with span("stage1.to_device"):
            inputs = [dev(a) for a in (x_raw, refs, l1, l2)]
        out = nll_analysis_core(
            *inputs,
            patch_size=patch_size_from_voxel(voxel_size),
            voxel_size=voxel_size,
            num_label_classes=num_classes,
            side=intensity_prior,
            apply_otsu=apply_otsu,
            debug=debug,
        )
        dbg = None
        if debug:
            out, dbg = out[:-1], {k: _numpy(v) for k, v in out[-1].items()}
        (anomaly, m_valid, x_norm, avg_label, cx, cy, cr, crs, thr) = [_numpy(o) for o in out]
        return AnalysisResult(anomaly, m_valid, x_norm, avg_label, cx, cy, cr, crs,
                              float(thr), debug=dbg), hdr, voxel_size

    def _save_debug(self, case_dir, result, hdr):
        """The debug intermediates, with the per-reference aligned images
        and anomaly maps under references/."""
        dbg = result.debug
        for key in ("intensity_thr", "rough_brain", "local_mean", "mean_value", "std_value"):
            nifti.save_nifti(dbg[key], hdr, join_path(case_dir, key + ".nii.gz"))
        ref_dir = mkdir(join_path(case_dir, "references"))
        for k in range(dbg["ref_aligned"].shape[0]):
            nifti.save_nifti(dbg["ref_aligned"][k], hdr, join_path(ref_dir, "ref%02d.nii.gz" % k))
            nifti.save_nifti(dbg["ref_anomaly"][k], hdr,
                             join_path(ref_dir, "ref%02d_anomaly.nii.gz" % k))

    def _save_case_artifacts(self, case, result, hdr, intensity_prior):
        case_dir = join_path(self.output_folder, case)
        if result.debug is not None:
            self._save_debug(case_dir, result, hdr)
        for key, data in (("normalized_input", result.normalized_input),
                          ("anomaly_score", result.anomaly),
                          ("valid_mask", result.valid_mask),
                          ("averaged_label", result.averaged_label)):
            nifti.save_nifti(data, hdr, join_path(case_dir, key + ".nii.gz"))
        # gzipped on the way when the input is a plain .nii (a byte copy
        # under the .nii.gz name would not read back)
        nifti.copy_nifti(self.data_dict[case]["x"],
                         join_path(case_dir, "preprocessed_image.nii.gz"))
        summary = {
            "preprocessed_image": self.data_dict[case]["x"],
            "intensity_prior": intensity_prior,
            "autoseg_threshold": result.threshold,
            "histogram_curves": {
                "x": result.curve_x.tolist(),
                "y": result.curve_y.tolist(),
                "r": result.curve_r.tolist(),
            },
        }
        try:
            from deepwmh_tpu_torch.eval.plots import hist_curve_plot

            with span("stage1.plot"):
                hist_curve_plot(result.curve_x, result.curve_y, result.curve_r,
                                result.curve_rs, join_path(case_dir, "histogram_curves.png"))
        except Exception as e:  # the plot must never fail the analysis
            self.log("histogram plot failed for %s: %s" % (case, e))
        # summary.json marks the case complete, so it is written last
        atomic_write_json(summary, join_path(case_dir, "summary.json"))

    def _auto_batch_cases(self, shape, K, n_devices: int = 1) -> int:
        """Cases a chunk: the core holds ~5 K-stacked f32 volumes a case,
        budgeted at ~6 GB a device; with a mesh a multiple of the device
        count, at most 4 rounds a device (the JAX package's sizing)."""
        vox = int(np.prod(shape))
        per_case = (5 * K + 10) * 4 * vox
        per_device = int(max(1, 6_000_000_000 // max(per_case, 1)))
        if n_devices <= 1:
            return min(8, per_device)
        return min(4 * n_devices, max(1, per_device) * n_devices)

    def _chunks(self, todo, batch_cases, debug, mesh=None):
        """Chunks of same-geometry cases (shape, spacing, K): ``batch_cases``
        a chunk; 'auto' is one case at a time without a mesh (batching pays
        where the cases spread over a mesh, as in the JAX package) and
        ``_auto_batch_cases`` with one."""
        groups = {}
        for case in todo:
            info = self.data_dict[case]
            shape = tuple(int(s) for s in nifti.get_nifti_header(info["x"]).shape[:3])
            voxel = tuple(round(v, 4) for v in nifti.get_nifti_pixdim(info["x"]))
            groups.setdefault((shape, voxel, len(info["r"])), []).append(case)
        chunks = []
        for (shape, _voxel, K), cases in groups.items():
            if batch_cases == "auto":
                B = 1 if mesh is None else self._auto_batch_cases(shape, K, mesh.size)
            else:
                B = max(int(batch_cases), 1)
            if debug:
                B = 1  # debug intermediates are a per-case artifact set
            chunks += [cases[i:i + B] for i in range(0, len(cases), B)]
        return chunks

    def _analyze_chunk_batched(self, chunk, loaded, intensity_prior, debug, mesh=None):
        """A chunk of same-geometry cases: split by ``num_label_classes``
        (one batch must share it), a group of one through ``analyze_case``
        on the analyzer's device, a larger one as one ``nll_analysis_batch``
        (on the analyzer's device, or over ``mesh``: a block of cases a
        shard). Returns [(AnalysisResult, header)] in chunk order."""
        groups = {}
        for i, ld in enumerate(loaded):
            groups.setdefault(_label_count(ld[5]), []).append(i)
        results = [None] * len(chunk)
        for num_classes, idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                self.log("analyzing case %s" % chunk[i])
                result, hdr, _ = self.analyze_case(chunk[i], intensity_prior=intensity_prior,
                                                   loaded=loaded[i], debug=debug)
                results[i] = (result, hdr)
                continue
            self.log("analyzing cases %s (one batch)" % ", ".join(chunk[i] for i in idxs))
            voxel_size = loaded[idxs[0]][2]
            out = nll_analysis_batch(
                *(np.stack([loaded[i][k] for i in idxs]) for k in (0, 3, 4, 5)),
                patch_size=patch_size_from_voxel(voxel_size), voxel_size=voxel_size,
                num_label_classes=num_classes, side=intensity_prior, mesh=mesh,
                device=self.device)
            out = [_numpy(o) for o in out]
            for j, i in enumerate(idxs):
                results[i] = (AnalysisResult(*(o[j] for o in out[:8]), float(out[8][j])),
                              loaded[i][1])
        return results

    def analyze_and_do_segmentation(self, intensity_prior="+", do_postprocessing=True,
                                    debug=False, batch_cases="auto", mesh=None):
        """Analyse every case without a summary.json, then segment every
        case whose segmentation is missing.

        Same-geometry cases form chunks of ``batch_cases`` (``_chunks``:
        'auto' is 1 without a mesh, ``_auto_batch_cases(shape, K,
        mesh.size)`` with one; ``debug`` forces 1); the next chunk's files
        are read while the current one computes. A chunk of several cases
        runs as one batch (``_analyze_chunk_batched``; the JAX package's
        ``vmap``): on the analyzer's device, or with ``mesh`` (a
        ``parallel.mesh.Mesh``: stage-1 over a mesh) through
        ``nll_analysis_batch(mesh=)``, each shard's block of cases one batch
        on its device. Every path writes the one-case path's artifacts, so a
        run resumes another's."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deepwmh_tpu_torch.parallel.mesh.Mesh, got %r"
                            % (mesh,))
        if not (batch_cases == "auto" or isinstance(batch_cases, int)):
            raise ValueError("batch_cases must be 'auto' or an int, got %r" % (batch_cases,))

        todo = []
        for case in self.data_dict:
            case_dir = mkdir(join_path(self.output_folder, case))
            if os.path.isfile(join_path(case_dir, "summary.json")):
                self.log("case %s: summary exists, skip analysis" % case)
            else:
                todo.append(case)

        chunks = self._chunks(todo, batch_cases, debug, mesh)

        def load_chunk(cases):  # on the reader thread
            with span("stage1.read"):
                return [self._load_case(c) for c in cases]

        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(load_chunk, chunks[0]) if chunks else None
            for i, chunk in enumerate(chunks):
                with span("stage1.read_wait"):
                    loaded = future.result()
                if i + 1 < len(chunks):  # read the next chunk while this one runs
                    future = pool.submit(load_chunk, chunks[i + 1])
                results = self._analyze_chunk_batched(chunk, loaded, intensity_prior, debug,
                                                      mesh)
                for case, (result, hdr) in zip(chunk, results):
                    self._save_case_artifacts(case, result, hdr, intensity_prior)

        # segmentation for EVERY case, including those whose analysis was
        # skipped: a deleted segmentation is recomputed from the artifacts
        for case in self.data_dict:
            case_dir = join_path(self.output_folder, case)
            pre_path = join_path(case_dir, "preprocessed_image.nii.gz")
            seg_path = join_path(case_dir, "segmentation.nii.gz")
            if not nifti.try_load_nifti(seg_path):
                with open(join_path(case_dir, "summary.json")) as f:
                    thr = json.load(f)["autoseg_threshold"]
                anomaly = nifti.load_nifti_simple(join_path(case_dir, "anomaly_score.nii.gz"))
                seg = (anomaly > thr).astype(np.float32)
                nifti.save_nifti(seg, nifti.get_nifti_header(pre_path), seg_path)
                with open(join_path(case_dir, "segmentation.txt"), "w") as f:
                    f.write("case name: %s\n" % case)
                    f.write("segmentation threshold: %.4f\n" % thr)

            # post-processing: 3 mm spark removal
            pp_path = join_path(case_dir, "segmentation_pp.nii.gz")
            if do_postprocessing and not nifti.try_load_nifti(pp_path):
                seg = nifti.load_nifti_simple(seg_path)
                seg_t = torch.from_numpy(np.ascontiguousarray(seg)).to(self.device)
                with span("stage1.sparks"):
                    seg_pp = remove_3mm_sparks(seg_t, nifti.get_nifti_pixdim(pre_path))
                seg_pp = _numpy(seg_pp)
                nifti.save_nifti(seg_pp, nifti.get_nifti_header(pre_path), pp_path)

        self.log("stage-1 analysis finished for %d case(s)" % len(self.data_dict))
