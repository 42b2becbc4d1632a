"""DeepWMH_priors on the GPU: ``python -m deepwmh_tpu_torch.cli.priors``.

Builds tissue priors by atlas propagation (in place of the reference
experiments' FreeSurfer recon-all pathway): register one labelled atlas to
each subject and carry the 4-class labels across. Emits label1 (brain mask)
and label2 (tissue classes) per subject and a manifest, the columns the
reference.csv contract needs. Same flags as ``deepwmh_tpu.cli.priors``,
plus ``-g i | --device cpu``: CUDA by default, the CPU only when asked for.
"""

from __future__ import annotations

import argparse

import numpy as np

from deepwmh_tpu_torch.cli.group_register import add_device_args, device_from_args
from deepwmh_tpu_torch.core import nifti
from deepwmh_tpu_torch.core.artifacts import join_path, mkdir
from deepwmh_tpu_torch.core.manifests import load_csv_simple, write_csv_simple


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate label1/label2 tissue priors for a cohort by registering a "
        "labeled atlas to each subject (PyTorch/CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-a", "--atlas-image", type=str)
    parser.add_argument("-l", "--atlas-label", type=str,
                        help="4-class label volume (0 bg, 1 cerebrum, 2 cerebellum+brainstem, "
                        "3 cortex).")
    parser.add_argument("-i", "--input-csv", type=str, help="CSV with columns (case, flair).")
    parser.add_argument("-o", "--output-folder", type=str)
    parser.add_argument("--affine-only", action="store_true")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--make-atlas", type=str, metavar="PREFIX",
                        help="Write <PREFIX>_image.nii.gz + <PREFIX>_label.nii.gz and use "
                        "them as the atlas: from --from-aseg (a FreeSurfer aseg volume, "
                        "remapped exactly as the reference's convert_FreeSurfer_aseg), or "
                        "a built-in synthetic 4-class head when no source is given.")
    parser.add_argument("--from-aseg", type=str, metavar="ASEG",
                        help="FreeSurfer aseg parcellation to remap into the 4-class atlas "
                        "label (use with --make-atlas; pair with --aseg-image).")
    parser.add_argument("--aseg-image", type=str, metavar="IMG",
                        help="Intensity image in the aseg's grid, stored as the atlas image "
                        "(with --from-aseg).")
    add_device_args(parser)
    args = parser.parse_args(argv)
    device = device_from_args(parser, args)

    if args.make_atlas:
        from deepwmh_tpu_torch.registration.priors import (
            convert_freesurfer_aseg,
            synthetic_atlas,
        )

        img_path = args.make_atlas + "_image.nii.gz"
        lbl_path = args.make_atlas + "_label.nii.gz"
        if args.from_aseg:
            if not args.aseg_image:
                parser.error("--from-aseg requires --aseg-image")
            aseg, hdr = nifti.load_nifti(args.from_aseg)
            label = convert_freesurfer_aseg(aseg).astype(np.float32)
            image = nifti.load_nifti_simple(args.aseg_image).astype(np.float32)
        else:
            image, label = synthetic_atlas()
            hdr = nifti.NiftiHeader()
            hdr.set_shape(image.shape)
            hdr.set_zooms((2.0, 2.0, 2.0))
        nifti.save_nifti(image, hdr, img_path)
        nifti.save_nifti(label, hdr, lbl_path)
        print("atlas written: %s, %s" % (img_path, lbl_path))
        args.atlas_image = args.atlas_image or img_path
        args.atlas_label = args.atlas_label or lbl_path
        if not args.input_csv:
            return  # atlas-only invocation

    missing = [n for n, v in (("-a/--atlas-image", args.atlas_image),
                              ("-l/--atlas-label", args.atlas_label),
                              ("-i/--input-csv", args.input_csv),
                              ("-o/--output-folder", args.output_folder)) if not v]
    if missing:
        parser.error("missing required arguments: %s" % ", ".join(missing))

    from deepwmh_tpu_torch.device import resolve_device
    from deepwmh_tpu_torch.registration.priors import propagate_atlas

    device = resolve_device(device)  # before any work: no card and no --device cpu raises
    table = load_csv_simple(args.input_csv, key_names=["case", "flair"])
    out = mkdir(args.output_folder)
    atlas_img = nifti.load_nifti_simple(args.atlas_image)
    atlas_lbl = nifti.load_nifti_simple(args.atlas_label)
    atlas_sp = nifti.get_nifti_pixdim(args.atlas_image)

    rows = {"case": [], "flair": [], "label1": [], "label2": []}
    for case, flair in zip(table["case"], table["flair"]):
        l1_path = join_path(out, "%s_label1.nii.gz" % case)
        l2_path = join_path(out, "%s_label2.nii.gz" % case)
        if not (nifti.try_load_nifti(l1_path) and nifti.try_load_nifti(l2_path)):
            print("priors: %s" % case, flush=True)
            subj, hdr = nifti.load_nifti(flair)
            label, mask = propagate_atlas(
                atlas_img, atlas_lbl, subj, atlas_spacing=atlas_sp,
                subject_spacing=nifti.get_nifti_pixdim(flair), quick=args.quick,
                deformable=not args.affine_only, device=device)
            nifti.save_nifti(mask.astype(np.float32), hdr, l1_path)
            nifti.save_nifti(label.astype(np.float32), hdr, l2_path)
        rows["case"].append(case)
        rows["flair"].append(flair)
        rows["label1"].append(l1_path)
        rows["label2"].append(l2_path)
    write_csv_simple(join_path(out, "priors_manifest.csv"), rows)
    print("priors written to %s" % out)


if __name__ == "__main__":
    main()
