"""dcm2niix_py: recursive DICOM -> NIfTI conversion.

    python -m deepwmh_tpu_torch.cli.dcm2niix -i <dicom dir> -o <out> [--no-compress]

The port's counterpart of the JAX package's ``dcm2niix_py`` (and of the
reference's dcm2niix adapter) with the same flags and output names
(``series_%03d.nii.gz``). Host only, like ``cli/convert_torch.py``: no
``--device``. Transfer syntaxes (core/dicom.py): uncompressed little and big
endian (explicit / implicit VR), Deflated, RLE Lossless, JPEG (Baseline,
Extended 12-bit, Lossless Process 14 / SV1), JPEG-LS and JPEG 2000; classic
single-frame series and enhanced multi-frame files. The native decoders
(``deepwmh_tpu_torch/native``) build with ``g++`` at first use; without a
compiler the conversion raises.
"""

from __future__ import annotations

import argparse

from deepwmh_tpu_torch.core.dicom import convert_directory


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert DICOM series to NIfTI recursively.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-i", "--input", type=str, required=True,
                        help="Directory containing DICOM files (searched recursively).")
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="Output directory for NIfTI volumes.")
    parser.add_argument("--no-compress", action="store_true",
                        help="Write .nii instead of .nii.gz.")
    args = parser.parse_args(argv)
    written = convert_directory(args.input, args.output, compress=not args.no_compress)
    print("%d series converted." % len(written))
    return written


if __name__ == "__main__":
    main()
