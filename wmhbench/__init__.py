"""The benchmark of ``deepwmh_tpu_torch``, the PyTorch and CUDA port of
DeepWMH, on an NVIDIA H100. ``python3 -m wmhbench.run --help``; cells and
metrics are listed in ``BENCHMARK.json`` at the repository root."""
