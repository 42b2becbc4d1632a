"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. With no CUDA
device and no explicit CPU request they raise: a run never carries on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; ``"cuda:i"`` / ``"cpu"`` /
    a ``torch.device`` select explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError("unsupported device %r (use cuda, cuda:i or cpu)" % (device,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; ask for the CPU explicitly "
            "(device='cpu', or --device cpu on the CLI) to run there")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError("cuda:%d requested but only %d CUDA device(s) visible"
                           % (index, torch.cuda.device_count()))
    return torch.device("cuda", index)
