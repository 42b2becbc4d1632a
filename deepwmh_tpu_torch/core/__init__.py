from deepwmh_tpu_torch.core.nifti import (  # noqa: F401
    NiftiHeader,
    load_nifti,
    load_nifti_simple,
    save_nifti,
    save_nifti_simple,
    get_nifti_header,
    get_nifti_pixdim,
    try_load_nifti,
    resample_nifti,
    nifti_main_axis,
)
