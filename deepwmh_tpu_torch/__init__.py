"""deepwmh_tpu_torch — the PyTorch/CUDA port of deepwmh_tpu for NVIDIA Hopper.

A second package beside the JAX one, mirroring its layout:

- ``core``      NIfTI I/O, artifact helpers, dataset checks
- ``ops``       volume ops (N4, resampling, histograms, morphology,
                connected components, brain mask, cohort statistics, NLL,
                rank filters) and the hand-written CUDA kernels with their
                plain PyTorch versions (``ops/kernels.py``, sources in
                ``csrc/``)
- ``unet``      plan, model-package reader/writer, 3D U-Net, inference
- ``pipeline``  the per-case predict pipeline with resumable artifacts, and
                stage-1 NLL lesion analysis (``pipeline/analysis.py``)
- ``eval``      the GIF preview and stage-1's histogram plot
- ``utils``     logging and threaded host I/O
- ``cli``       ``python -m deepwmh_tpu_torch.cli.predict``

Entry points run on CUDA unless the caller asks for the CPU. The package
imports torch and never jax, flax or deepwmh_tpu; model packages are shared
with deepwmh_tpu in both directions.
"""

__version__ = "0.1.0"
