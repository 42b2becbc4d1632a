"""Unpack a released model package: ``python -m
deepwmh_tpu_torch.cli.install_model -m model_release.tar.gz -o <dir>``.

The flags of ``deepwmh_tpu.cli.install_model`` (``-m/--model-targz``, with
``-i/--input`` as an alias, ``-o``, ``-f/--force``) and its refusal to
install into a non-empty directory without ``-f``. Packages are
relocatable, so installing is extracting and validating.
"""

from __future__ import annotations

import argparse
import os

from deepwmh_tpu_torch.unet.release import install_model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Install a released DeepWMH model (tar.gz) for the PyTorch/CUDA port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-m", "--model-targz", "-i", "--input", dest="input",
                        type=str, required=True,
                        help="Pre-trained model file (in *.tar.gz format).")
    parser.add_argument("-o", "--install-location", "--output-folder",
                        dest="output_folder", type=str, required=True,
                        help="Model install location.")
    parser.add_argument("-f", "--force", action="store_true",
                        help="Overwrite if model already exists.")
    args = parser.parse_args(argv)

    dest = args.output_folder
    if os.path.isdir(dest) and len(os.listdir(dest)) > 0:
        if not args.force:
            raise SystemExit(
                "Model can be only installed in an empty directory! "
                'Add "-f" to overwrite existing model (not recommended).')
        print("WARNING: overwriting previously installed model...")
    dest = install_model(args.input, dest)
    print("Model installed to: %s" % dest)
    print('Use it with: python -m deepwmh_tpu_torch.cli.predict -m "%s" ...' % dest)


if __name__ == "__main__":
    main()
