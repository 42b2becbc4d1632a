"""Per-case inference pipeline: N4 -> U-Net sweep -> 3 mm spark removal ->
brain-FOV mask -> GIF preview, with the artifact layout and resume
semantics of ``deepwmh_tpu.pipeline.inference``.

Shared by the predict CLI and the serving loop (``pipeline/serve.py``). A
fresh case (no artifacts yet) runs the whole device pipeline in one call
(``SlidingWindowPredictor.predict_case_full``, or the mesh-sharded
predictor's); a burst of fresh same-geometry cases runs it once over the
batch (``predict_batch_cases``). A volume that N4 would spread over the
cards (``ops/n4.n4_would_shard``: >= 64M voxels, several cards, the run not
pinned) takes the staged path instead, with the sharded N4 first, as the
JAX package's ``_can_fuse`` gate routes it. A partially computed case runs
stage by stage, probing each artifact with ``try_load_nifti``, so a rerun
resumes where it stopped. Both paths mark their stages with the same
``predict.*`` spans (``utils/profiling.span``).
"""

from __future__ import annotations

import numpy as np
import torch

from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import join_path, mkdir
from deepwmh_tpu_torch.ops.brain import brain_extract
from deepwmh_tpu_torch.ops.components import remove_3mm_sparks
from deepwmh_tpu_torch.ops.n4 import n4_bias_correction_auto, n4_would_shard
from deepwmh_tpu_torch.utils.profiling import span


def make_output_folders(output_folder):
    """Create the output layout; returns a dict of the five folders."""
    out = mkdir(output_folder)
    seg_folder = mkdir(join_path(out, "002_Segmentations"))
    return {
        "images": mkdir(join_path(out, "001_Preprocessed_Images")),
        "raw": mkdir(join_path(seg_folder, "001_raw")),
        "post_3mm": mkdir(join_path(seg_folder, "002_postproc_3mm")),
        "post_fov": mkdir(join_path(seg_folder, "003_postproc_fov")),
        "previews": mkdir(join_path(out, "003_Previews")),
    }


@span("predict.to_host")
def _numpy(t):
    return t.cpu().numpy()


@span("predict.preview")
def _render_preview(folders, case, raw_data, fov_data, image_path=None, seg_path=None):
    """Best-effort GIF preview: a rendering error (or a host without PIL)
    never fails a case whose segmentation artifacts are on disk.
    raw_data/fov_data may be None; they are then loaded from
    image_path/seg_path, and only if the GIF is missing."""
    from deepwmh_tpu_torch.eval.preview import nii_as_gif, nii_slice_range, try_load_gif

    out_gif = join_path(folders["previews"], "%s.gif" % case)
    try:
        if not try_load_gif(out_gif):
            data = raw_data if raw_data is not None else nifti.load_nifti_simple(image_path)
            seg = fov_data if fov_data is not None else nifti.load_nifti_simple(seg_path)
            s0, s1 = nii_slice_range(data, axis="axial")
            nii_as_gif(data, out_gif, axis="axial", lesion_mask=seg,
                       side_by_side=True, slice_range=(s0, s1))
    except Exception as e:
        print("warning: preview rendering failed for %s: %r" % (case, e), flush=True)


def _can_fuse(predictor, shape, skip_bfc) -> bool:
    """The fused case program runs N4 on the predictor's device; a volume
    the auto router would shard keeps the staged path. The router's own
    predicate, so a fresh and a resumed case give the same N4 output."""
    return skip_bfc or not n4_would_shard(shape, predictor.pinned)


def _case_paths(folders, case):
    """(pre, raw seg, 3 mm seg, FOV seg) artifact paths of ``case``."""
    return (join_path(folders["images"], "%s_0000.nii.gz" % case),
            join_path(folders["raw"], "%s.nii.gz" % case),
            join_path(folders["post_3mm"], "%s.nii.gz" % case),
            join_path(folders["post_fov"], "%s.nii.gz" % case))


def _save_full(outs, hdr, paths):
    """Write the fused path's (pre, seg_raw, seg_3mm, seg_fov) artifacts;
    returns the FOV mask as numpy."""
    arrays = [_numpy(t) for t in outs[:4]]
    for arr, path in zip(arrays, paths):
        nifti.save_nifti(arr, hdr, path)
    return arrays[3]


@torch.inference_mode()
def predict_batch_cases(predictor, cases, folders, skip_bfc: bool = False,
                        make_previews: bool = True, preloads: dict | None = None):
    """A burst of same-geometry cases through one batched sweep
    (``predict_case_full_batch``), the serving burst path.

    ``cases``: [(case, image_path)], all of one volume shape and spacing
    (the caller groups them; checked here). ``preloads``: {case: (data,
    hdr)} already decoded. A case with artifacts on disk (resume needs the
    staged path) runs alone through predict_one_case, and so does every
    case when the burst fails: the batch is an optimisation, never a
    correctness boundary. Artifacts and previews equal the one-case path's.
    Returns {case: seg_fov_path}."""
    preloads = dict(preloads or {})
    batch, solo = [], []
    for case, image_path in cases:
        if case not in preloads:
            preloads[case] = nifti.load_nifti(image_path)
        data, hdr = preloads[case]
        if (any(nifti.try_load_nifti(p) for p in _case_paths(folders, case))
                or not _can_fuse(predictor, data.shape, skip_bfc)):
            solo.append((case, image_path))
        else:
            batch.append((case, image_path, data, hdr))

    out = {}
    if len(batch) >= 2:
        shapes = {d.shape for _, _, d, _ in batch}
        zooms = {tuple(round(float(z), 4) for z in h.zooms[:3]) for _, _, _, h in batch}
        if len(shapes) != 1 or len(zooms) != 1:
            raise ValueError("burst cases must share geometry: shapes=%s zooms=%s"
                             % (shapes, zooms))
        spacing = [abs(z) for z in next(iter(zooms))]
        try:
            stack = np.stack([np.asarray(d, np.float32) for _, _, d, _ in batch])
            outs = predictor.predict_case_full_batch(stack, spacing, apply_n4=not skip_bfc)
            for i, (case, _image_path, data, hdr) in enumerate(batch):
                paths = _case_paths(folders, case)
                fov = _save_full([o[i] for o in outs], hdr, paths)
                out[case] = paths[3]
                if make_previews:
                    _render_preview(folders, case, data, fov)
        except Exception as e:
            # any burst failure degrades to the per-case path (which
            # quarantines a bad input on its own when serving)
            print("burst of %d failed (%r); falling back to per-case" % (len(batch), e),
                  flush=True)
            solo.extend((case, p) for case, p, _, _ in batch)
    else:
        solo.extend((case, p) for case, p, _, _ in batch)

    for case, image_path in solo:
        out[case] = predict_one_case(predictor, case, image_path, folders, skip_bfc=skip_bfc,
                                     make_previews=make_previews, preloaded=preloads.get(case))
    return out


@torch.inference_mode()
def predict_one_case(predictor, case, image_path, folders, skip_bfc: bool = False,
                     make_previews: bool = True, preloaded=None):
    """One case through the full inference path with a warm predictor;
    every artifact is loadability-probed so re-running resumes. Returns the
    path of the FOV-masked segmentation.

    ``preloaded``: (data, hdr) of image_path, already decoded (the serving
    loop's prefetch); whichever path runs reuses it."""
    dev = predictor.device
    pre_path, raw_seg, seg_3mm, seg_fov = _case_paths(folders, case)

    raw_data = None
    fov_data = None
    # (data, hdr) of image_path, reused by whichever path runs
    loaded = preloaded
    fused = not any(nifti.try_load_nifti(p) for p in (pre_path, raw_seg, seg_3mm, seg_fov))
    if fused:
        if loaded is None:
            loaded = nifti.load_nifti(image_path)
        raw_data, hdr = loaded
        fused = _can_fuse(predictor, raw_data.shape, skip_bfc)
    if fused:
        spacing = [float(abs(z)) for z in hdr.zooms[:3]]
        outs = predictor.predict_case_full(raw_data, spacing, apply_n4=not skip_bfc)
        fov_data = _save_full(outs, hdr, (pre_path, raw_seg, seg_3mm, seg_fov))
    else:
        # stage-by-stage path: resume granularity = one artifact
        if not nifti.try_load_nifti(pre_path):
            raw_data, hdr = loaded if loaded is not None else nifti.load_nifti(image_path)
            if skip_bfc:
                nifti.save_nifti(raw_data, hdr, pre_path)
            else:
                with span("predict.n4"):
                    corrected = n4_bias_correction_auto(
                        torch.from_numpy(np.array(raw_data)).to(dev), pinned=predictor.pinned)
                nifti.save_nifti(_numpy(corrected), hdr, pre_path)

        if not nifti.try_load_nifti(raw_seg):
            data, hdr = nifti.load_nifti(pre_path)
            seg, _fg = predictor.predict_case(data, nifti.get_nifti_pixdim(pre_path))
            nifti.save_nifti(_numpy(seg), hdr, raw_seg)

        if not nifti.try_load_nifti(seg_3mm):
            seg, hdr = nifti.load_nifti(raw_seg)
            spacing = nifti.get_nifti_pixdim(raw_seg)
            with span("predict.sparks"):
                seg_pp = remove_3mm_sparks(torch.from_numpy(np.array(seg)).to(dev), spacing)
            nifti.save_nifti(_numpy(seg_pp), hdr, seg_3mm)

        if not nifti.try_load_nifti(seg_fov):
            flair, hdr = nifti.load_nifti(pre_path)
            spacing = tuple(nifti.get_nifti_pixdim(pre_path))
            with span("predict.brain_mask"):
                mask = brain_extract(torch.from_numpy(np.array(flair)).to(dev), spacing)
            mask = _numpy(mask)
            seg = nifti.load_nifti_simple(seg_3mm)
            nifti.save_nifti(((seg * mask) > 0.5).astype(np.float32), hdr, seg_fov)

    if make_previews:
        _render_preview(folders, case, raw_data, fov_data,
                        image_path=image_path, seg_path=seg_fov)
    return seg_fov
