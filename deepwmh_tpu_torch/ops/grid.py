"""Separable endpoint-aligned resizing (port of ``deepwmh_tpu.ops.grid``'s
``_linear_resize_axis`` / ``_nearest_resize_axis``).

Written as ``index_select`` gathers with the same f32 coordinate and weight
arithmetic as the JAX functions, so the weights round the same way;
``F.interpolate`` would compute them differently. Nearest is
``floor(x + 0.5)`` on the endpoint-aligned grid, which is not torch's
``"nearest"``.
"""

from __future__ import annotations

import torch


def _grid(n_out: int, scale: float, device) -> torch.Tensor:
    return torch.arange(n_out, dtype=torch.float32, device=device) * scale


def linear_resize_axis(a: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """Endpoint-aligned linear interpolation along ``axis`` (zoom order=1)."""
    n_in = a.shape[axis]
    if n_in == n_out:
        return a
    if n_in == 1:
        idx = torch.zeros(n_out, dtype=torch.long, device=a.device)
        return a.index_select(axis, idx)
    x = _grid(n_out, (n_in - 1) / (n_out - 1), a.device)
    lo = torch.floor(x).long().clamp(0, n_in - 2)
    w = x - lo.float()
    shape = [1] * a.dim()
    shape[axis] = n_out
    w = w.view(shape)
    return a.index_select(axis, lo) * (1 - w) + a.index_select(axis, lo + 1) * w


def nearest_resize_axis(a: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = a.shape[axis]
    if n_in == n_out:
        return a
    x = _grid(n_out, (n_in - 1) / max(n_out - 1, 1), a.device)
    idx = torch.floor(x + 0.5).long().clamp(0, n_in - 1)
    return a.index_select(axis, idx)
