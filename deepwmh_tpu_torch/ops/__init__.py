"""The port's ops, re-exported as ``deepwmh_tpu.ops`` re-exports its own.
Importing them builds and loads nothing: the CUDA kernels build at their
first launch (``ops/kernels.py``)."""

from deepwmh_tpu_torch.ops.stats import (  # noqa: F401
    masked_mean,
    masked_std,
    z_score,
    group_mean,
    group_std,
)
from deepwmh_tpu_torch.ops.nll import nll  # noqa: F401
from deepwmh_tpu_torch.ops.grid import mean_std_grid  # noqa: F401
from deepwmh_tpu_torch.ops.histogram import (  # noqa: F401
    masked_histogram,
    otsu_threshold,
    hist_curve,
    histogram_analysis,
)
from deepwmh_tpu_torch.ops.filters import (  # noqa: F401
    mean_filter,
    median_filter,
    min_filter,
    max_filter,
    median_3mm,
)
from deepwmh_tpu_torch.ops.components import (  # noqa: F401
    label_components,
    component_sizes,
    remove_sparks,
    remove_3mm_sparks,
    component_filtering,
    largest_component,
    average_contiguous_labels,
    map_label,
)
from deepwmh_tpu_torch.ops.morphology import (  # noqa: F401
    binary_erosion_2d,
    binary_dilation_2d,
    binary_erosion_3d,
    binary_dilation_3d,
)
