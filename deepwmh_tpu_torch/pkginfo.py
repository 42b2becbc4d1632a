"""Package metadata of the port (``deepwmh_tpu.pkginfo``'s counterpart)."""

__version__ = "0.1.0"
__package_name__ = "deepwmh_tpu_torch"
