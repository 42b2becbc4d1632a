"""Import a reference (PyTorch nnU-Net) trained model: ``python -m
deepwmh_tpu_torch.cli.convert_torch -i <install root | trainer folder |
model_best.model> -o <package>``.

The flags of ``DeepWMH_convert`` (``-i``, ``-o``, ``-p``, ``--which``):
the reference's released or installed checkpoint becomes a relocatable
model package that the predict, serve and evaluate CLIs of either package
read. Conversion runs on the host; no device is needed.
"""

from __future__ import annotations

import argparse
import os

from deepwmh_tpu_torch.unet.torch_convert import (
    convert_nnunet_model,
    find_nnunet_model,
    find_nnunet_plans,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a reference DeepWMH (PyTorch nnU-Net) model "
        "into a model package for the PyTorch/CUDA port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-i", "--input", type=str, required=True,
                        help="Installed reference model root, trainer "
                        "folder, or a model_best.model file.")
    parser.add_argument("-o", "--output-folder", type=str, required=True,
                        help="Output package folder (plan.json + weights).")
    parser.add_argument("-p", "--plans", type=str, default=None,
                        help="plans.pkl path (auto-discovered when omitted).")
    parser.add_argument("--which", type=str, default=None,
                        help="Which reference checkpoint file to convert "
                        "(e.g. model_latest.model). Default: model_best, "
                        "then final, then latest.")
    args = parser.parse_args(argv)

    model = find_nnunet_model(args.input, which=args.which)
    plans = args.plans if args.plans is not None else find_nnunet_plans(
        model, args.input if os.path.isdir(args.input) else None)
    print("checkpoint: %s" % model)
    print("plans:      %s" % plans)
    out = convert_nnunet_model(model, plans, args.output_folder)
    print("Model package written to: %s" % out)
    print('Use it with: python -m deepwmh_tpu_torch.cli.predict -m "%s" ...' % out)


if __name__ == "__main__":
    main()
