"""deepwmh_tpu_torch — the PyTorch/CUDA port of deepwmh_tpu for NVIDIA Hopper.

A second package beside the JAX one, mirroring its layout:

- ``core``      NIfTI I/O, artifact helpers and marker checkpoints, dataset
                checks, xlsx workbooks, the DICOM import (series -> NIfTI)
                with its JPEG, JPEG-LS and JPEG 2000 codecs
- ``native``    the import's host C++ hot loops, built with g++ at first use
- ``ops``       volume ops (N4, resampling, histograms, morphology,
                connected components and selection, brain mask, cohort
                statistics, NLL, rank filters) and the hand-written CUDA
                kernels with their plain PyTorch versions
                (``ops/kernels.py``, sources in ``csrc/``)
- ``unet``      plan, model packages (write, release, install), 3D U-Net,
                inference, training, FLOP counts, the conversion of the
                reference's PyTorch nnU-Net checkpoints
- ``pipeline``  the per-case predict pipeline with resumable artifacts,
                serving, stage-1 NLL lesion analysis and the 3-stage
                self-training pipeline (``pipeline/multistage.py``)
- ``registration``  affine + SVF group registration, the warm start, the
                learned mode, tissue priors, the mode policy
- ``eval``      voxel and instance metrics with their evaluation harnesses,
                statistics and blinded rating workbooks, PDF cards,
                colormaps, previews and plots, phantom cohorts and the
                train -> predict accuracy harness
- ``utils``     logging, threaded host I/O, Adam, tables, stage timers and
                traces, small helpers
- ``cli``       ``python -m deepwmh_tpu_torch.cli.<predict | serve | train |
                install_model | group_register | priors | convert_torch |
                evaluate | dcm2niix>``
- ``experiments``  the OASIS-3 replication recipe (``experiments.oasis3``)

Entry points run on CUDA unless the caller asks for the CPU. The package
imports torch and never jax, flax or deepwmh_tpu; model packages are shared
with deepwmh_tpu in both directions.
"""

from deepwmh_tpu_torch.pkginfo import __version__  # noqa: F401
