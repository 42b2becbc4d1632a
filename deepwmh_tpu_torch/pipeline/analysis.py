"""Stage-1 lesion analysis: the NLL anomaly pipeline (port of
``deepwmh_tpu.pipeline.analysis``).

Per case, on one device:

  rough brain mask from the registered label1 cohort -> z-score -> Otsu
  valid mask -> tissue-min background fill -> 50 mm local-mean alignment of
  every reference to the target -> voxelwise Gaussian NLL with a one-sided
  prior -> per-slice component filtering -> per-reference anomaly
  histograms -> zero-crossing auto-threshold -> cerebellum/brainstem 3 mm
  median (K2 at a 3x3x3 kernel) -> majority-vote tissue masking.

``LesionAnalyzer`` handles the NIfTI I/O, the idempotent artifacts and the
per-case summary, with the JAX package's output contract (anomaly_score /
valid_mask / normalized_input / averaged_label / preprocessed_image /
segmentation[_pp] / summary.json + segmentation.txt). Over a device mesh
(``analyze_and_do_segmentation(mesh=)``) the cases are dealt over the
shards, each analysed whole on its shard's device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
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
from deepwmh_tpu_torch.ops.stats import group_mean, z_score
from deepwmh_tpu_torch.parallel.mesh import Mesh
from deepwmh_tpu_torch.utils.logging import SimpleTxtLog, TimeStamps
from deepwmh_tpu_torch.utils.parallel import run_parallel

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


@contextlib.contextmanager
def _stage(stage_s, name, device):
    """Add the device seconds of the block to ``stage_s[name]``, with the
    device synchronised on both sides; nothing when ``stage_s`` is None."""
    if stage_s is None:
        yield
        return
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda _d: None)
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0


def _fill_background(t, m_rough):
    """Voxels outside the rough brain take the tissue minimum."""
    tissue_min = torch.where(m_rough > 0.5, t, torch.inf).min()
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
    *,
    stage_s=None,
):
    """x_raw [D, H, W]; refs_raw / label1s / label2s [K, D, H, W], all on
    one device and registered to the target.

    Returns (anomaly, valid_mask, normalized_input, averaged_label, curve_x,
    curve_y, curve_r, curve_rs, threshold), tensors on that device. With
    debug=True a dict of intermediates is appended: the per-voxel intensity
    threshold back-solved from the anomaly threshold, the rough brain mask,
    the local mean, the cohort mean and std, and the aligned references
    with their anomaly maps. With ``stage_s`` a dict, the device seconds of
    each stage are added to it."""
    K = refs_raw.shape[0]

    def stage(name):
        return _stage(stage_s, name, x_raw.device)

    with stage("mask_zscore_otsu"):
        # rough brain mask: the cohort's label1 majority
        m_rough = (group_mean((label1s > 0.5).float()) > 0.5).float()
        x = z_score(x_raw.float(), mask=m_rough)
        if apply_otsu:
            otsu_thr = otsu_threshold(torch.where(m_rough < 0.5, x.min(), x))
            m_otsu = (x > otsu_thr).float()
        else:
            m_otsu = torch.ones_like(x)
        m_valid = m_rough * m_otsu
        x = _fill_background(x, m_rough)
        refs = torch.stack([_fill_background(z_score(r.float(), mask=m_rough), m_rough)
                            for r in refs_raw])

    with stage("local_mean_alignment"):
        x_mu, _ = mean_std_grid(x, patch_size, mask=m_valid)
        if mean_correction:
            refs = torch.stack([r - mean_std_grid(r, patch_size, mask=m_valid)[0] + x_mu
                                for r in refs])

    with stage("nll"):
        # the target and every reference, each scored against the full cohort
        anomaly, x_mean, x_std = nll(x, refs, min_std=MIN_STD, side=side, return_all=True)
        anomaly_refs = nll_from_moments(refs, x_mean, x_std, side) * m_valid

    with stage("component_filtering"):
        anomaly = anomaly * component_filtering(m_valid, voxel_size)

    with stage("histogram_threshold"):
        curve_x, curve_y, curve_r, curve_rs = histogram_analysis(anomaly, anomaly_refs, m_valid)
        threshold = auto_threshold_from_curves(curve_x, curve_rs)

    with stage("tissue_vote"):
        avg_label = average_contiguous_labels(label2s, num_label_classes).float()
        anomaly = anomaly * (avg_label > 0.5).float()
        cb_mask = (avg_label > 1.5) & (avg_label < 2.5)
        tissue_majority = ((label2s > 0.5).float().sum(0) > K / 2.0).float()

    with stage("median_3mm"):
        anomaly_cb = median_3mm(anomaly, voxel_size)

    with stage("tissue_vote"):
        anomaly = torch.where(cb_mask, anomaly_cb, anomaly) * tissue_majority

    base = (anomaly, m_valid, x, avg_label, curve_x, curve_y, curve_r, curve_rs, threshold)
    if not debug:
        return base
    # thr = (t - mu)^2 / (2 sigma^2) + log(sigma * 2.506) solved for t on the
    # '+' side; a negative discriminant gives NaN (no intensity reaches it)
    d = 2.0 * (threshold - torch.log(x_std * 2.506))
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


def patch_size_from_voxel(voxel_size):
    """ceil(50 mm / pixdim) per axis."""
    return tuple(int(math.ceil(PHYSICAL_PATCH_MM / float(v))) for v in voxel_size)


def _numpy(t):
    return t.cpu().numpy()


class LesionAnalyzer:
    """Host orchestration: NIfTI in, idempotent artifacts out. Runs on
    CUDA unless ``device="cpu"`` is asked for (``resolve_device``)."""

    def __init__(self, output_folder: str, logger: SimpleTxtLog = None, device=None):
        self.device = resolve_device(device)
        self.output_folder = mkdir(output_folder)
        self.data_dict = {}
        self.logger = logger
        self.time_stamps = TimeStamps()

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
                     loaded=None, debug=False, stage_s=None, device=None):
        """Returns (AnalysisResult, header, voxel size). ``device``: where
        the case runs (the analyzer's device by default; a mesh shard's)."""
        x_raw, hdr, voxel_size, refs, l1, l2 = loaded or self._load_case(case)
        num_classes = int(np.max(l2.astype(np.int64))) + 1
        device = self.device if device is None else device

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

        out = nll_analysis_core(
            dev(x_raw), dev(refs), dev(l1), dev(l2),
            patch_size=patch_size_from_voxel(voxel_size),
            voxel_size=voxel_size,
            num_label_classes=num_classes,
            side=intensity_prior,
            apply_otsu=apply_otsu,
            debug=debug,
            stage_s=stage_s,
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

            hist_curve_plot(result.curve_x, result.curve_y, result.curve_r, result.curve_rs,
                            join_path(case_dir, "histogram_curves.png"))
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

    def _mesh_chunks(self, todo, mesh, batch_cases, debug):
        """Chunks of same-geometry cases (shape, spacing, K), sized by
        ``_auto_batch_cases`` for 'auto'."""
        groups = {}
        for case in todo:
            info = self.data_dict[case]
            shape = tuple(int(s) for s in nifti.get_nifti_header(info["x"]).shape[:3])
            voxel = tuple(round(v, 4) for v in nifti.get_nifti_pixdim(info["x"]))
            groups.setdefault((shape, voxel, len(info["r"])), []).append(case)
        chunks = []
        for (shape, _voxel, K), cases in groups.items():
            if batch_cases == "auto":
                B = self._auto_batch_cases(shape, K, mesh.size)
            else:
                B = max(int(batch_cases), 1)
            if debug:
                B = 1  # debug intermediates are a per-case artifact set
            chunks += [cases[i:i + B] for i in range(0, len(cases), B)]
        return chunks

    def _analyze_chunk(self, chunk, loaded, devices, intensity_prior, debug):
        """Case i of the chunk on ``devices[i % len(devices)]``; the cases of
        one device in order, each distinct card on a thread of its own.
        Returns [(AnalysisResult, header)] in chunk order."""
        by_device = {}
        for i in range(len(chunk)):
            by_device.setdefault(devices[i % len(devices)], []).append(i)

        def run(dev, idxs):
            out = []
            for i in idxs:
                self.log("analyzing case %s" % chunk[i])
                result, hdr, _ = self.analyze_case(chunk[i], intensity_prior=intensity_prior,
                                                   loaded=loaded[i], debug=debug, device=dev)
                out.append((i, (result, hdr)))
            return out

        if len(by_device) == 1:
            done = run(*next(iter(by_device.items())))
        else:
            with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
                futures = [pool.submit(run, dev, idxs) for dev, idxs in by_device.items()]
                done = [r for f in futures for r in f.result()]
        return [res for _, res in sorted(done, key=lambda r: r[0])]

    def analyze_and_do_segmentation(self, intensity_prior="+", do_postprocessing=True,
                                    debug=False, batch_cases="auto", mesh=None):
        """Analyse every case without a summary.json, then segment every
        case whose segmentation is missing.

        Without ``mesh`` the cases run one after another on the analyzer's
        device (the next case's files are read while the current one
        computes). With ``mesh`` (a ``parallel.mesh.Mesh``: stage-1 over a
        mesh) same-geometry cases form chunks of ``batch_cases`` ('auto':
        ``_auto_batch_cases(shape, K, mesh.size)``), whose cases are dealt
        over the shards in order, one case a shard at a time. Either way
        each case gives the one-by-one run's artifacts: the port runs no
        vmapped batch of cases."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a deepwmh_tpu_torch.parallel.mesh.Mesh, got %r"
                            % (mesh,))
        if not (batch_cases == "auto" or isinstance(batch_cases, int)):
            raise ValueError("batch_cases must be 'auto' or an int, got %r" % (batch_cases,))

        self.time_stamps.record("segmentation_start")
        todo = []
        for case in self.data_dict:
            case_dir = mkdir(join_path(self.output_folder, case))
            if os.path.isfile(join_path(case_dir, "summary.json")):
                self.log("case %s: summary exists, skip analysis" % case)
            else:
                todo.append(case)

        if mesh is None:
            chunks, devices = [[case] for case in todo], [self.device]
        else:
            chunks, devices = self._mesh_chunks(todo, mesh, batch_cases, debug), mesh.devices

        def load_chunk(cases):
            return [self._load_case(c) for c in cases]

        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(load_chunk, chunks[0]) if chunks else None
            for i, chunk in enumerate(chunks):
                loaded = future.result()
                if i + 1 < len(chunks):  # read the next chunk while this one runs
                    future = pool.submit(load_chunk, chunks[i + 1])
                results = self._analyze_chunk(chunk, loaded, devices, intensity_prior, debug)
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
                seg_pp = _numpy(remove_3mm_sparks(seg_t, nifti.get_nifti_pixdim(pre_path)))
                nifti.save_nifti(seg_pp, nifti.get_nifti_header(pre_path), pp_path)

        self.time_stamps.record("segmentation_end")
        self.log("stage-1 analysis finished for %d case(s)" % len(self.data_dict))
