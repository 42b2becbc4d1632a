from deepwmh_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_info,
    init_distributed,
    make_mesh,
)
