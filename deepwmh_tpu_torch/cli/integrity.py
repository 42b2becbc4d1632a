"""System integrity check for the port: torch importable, the requested
device usable, and on CUDA one launch of the instance-norm statistics
kernel (which builds it at first use) agreeing with its plain version."""

from __future__ import annotations


def check_system_integrity(device=None, verbose: bool = True) -> bool:
    def say(msg):
        if verbose:
            print(msg)

    try:
        import numpy  # noqa: F401
        import torch
    except ImportError as e:
        say("[!!] missing dependency: %s" % e)
        return False
    say("[OK] torch %s (CUDA %s)" % (torch.__version__, torch.version.cuda))

    from deepwmh_tpu_torch.device import resolve_device

    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        say("[!!] %s" % e)
        return False
    if dev.type == "cpu":
        say("[OK] running on the CPU, as requested")
        return True
    say("[OK] %s: %s" % (dev, torch.cuda.get_device_name(dev)))

    from deepwmh_tpu_torch.ops.kernels import (
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((1, 4, 4, 4, 32), generator=gen, device=dev).to(torch.bfloat16)
        mean, var = instance_norm_stats(x)
        ref_mean, ref_var = instance_norm_stats_reference(x)
        torch.cuda.synchronize(dev)
        ok = bool(torch.allclose(mean, ref_mean, atol=1e-4)
                  and torch.allclose(var, ref_var, atol=1e-4))
    except RuntimeError as e:
        say("[!!] instance-norm statistics kernel failed: %s" % e)
        return False
    say(("[OK]" if ok else "[!!]") + " instance-norm statistics kernel "
        + ("agrees with its plain version" if ok else "disagrees with its plain version"))
    return ok
