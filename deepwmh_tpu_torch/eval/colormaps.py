"""Vectorised piecewise-linear colormaps for previews (the port's copy of
``deepwmh_tpu.eval.colormaps``; the same stop tables and the same bytes).

A map is an [N, 4] stop table (position 0..1, r, g, b) interpolated over a
whole slice at once with np.interp: clamped below the first and above the
last stop. The reference's 11 map names carry its exact stop tables; a few
generic maps (hot, cold, jet, ...) are extensions.
"""

from __future__ import annotations

import numpy as np


def _rgb(r, g, b):
    return (r / 255.0, g / 255.0, b / 255.0)


# stop tables: (position 0..1, r, g, b) with channels 0..1
_MAPS = {
    # --- the reference's 11 maps (deepwmh/utilities/colormaps.py:36-159) ---
    "grayscale": [(0, 0, 0, 0), (1, 1, 1, 1)],
    # under/over sentinel colors at the 1% tails (colormaps.py:128-137)
    "grayscale2": [(0, 0, 0, 1), (0.01, 0, 0, 0), (0.99, 1, 1, 1), (1, 1, 0, 0)],
    "metalheat": [(0, 0, 0, 0), (0.17, 0, 0, 1), (0.44, 1, 0, 0),
                  (0.74, 1, 1, 0), (1, 1, 1, 1)],
    "rainbow": [(0, 0, 0, 0.5), (37 / 255, 0, 0, 1), (98 / 255, 0, 1, 1),
                (159 / 255, 1, 1, 0), (222 / 255, 1, 0, 0), (1, 0.5, 0, 0)],
    "highcontrast": [(0, 0, 0, 0), (0.99, 0, 1, 1), (1, 1, 0, 0)],
    "green": [(0, *_rgb(0, 68, 27)), (1, *_rgb(200, 233, 200))],
    "red": [(0, 1, 1, 1), (1, 0.86, 0.31, 0.31)],
    "blue": [(0, 1, 1, 1), (1, 0.16, 0.31, 0.67)],
    "plasma": [(0.00, *_rgb(13, 8, 135)), (0.14, *_rgb(84, 2, 163)),
               (0.29, *_rgb(139, 10, 165)), (0.43, *_rgb(185, 50, 137)),
               (0.57, *_rgb(219, 92, 104)), (0.71, *_rgb(244, 136, 73)),
               (0.86, *_rgb(254, 188, 43)), (1.00, *_rgb(240, 249, 33))],
    "ratio": [(0, 0, 0, 1), (0.5, 1, 1, 1), (1, 1, 0, 0)],
    "vik": [(0.00, *_rgb(0, 16, 95)), (0.10, *_rgb(1, 60, 123)),
            (0.20, *_rgb(29, 110, 156)), (0.30, *_rgb(111, 167, 194)),
            (0.40, *_rgb(200, 220, 229)), (0.50, 1, 1, 1),
            (0.60, *_rgb(233, 204, 188)), (0.70, *_rgb(210, 150, 115)),
            (0.80, *_rgb(188, 100, 50)), (0.90, *_rgb(138, 38, 4)),
            (1.00, *_rgb(88, 0, 6))],
    # --- extensions not in the reference ---
    "hot": [(0, 0, 0, 0), (0.4, 1, 0, 0), (0.8, 1, 1, 0), (1, 1, 1, 1)],
    "cold": [(0, 0, 0, 0), (0.4, 0, 0, 1), (0.8, 0, 1, 1), (1, 1, 1, 1)],
    "jet": [
        (0, 0, 0, 0.5), (0.125, 0, 0, 1), (0.375, 0, 1, 1),
        (0.625, 1, 1, 0), (0.875, 1, 0, 0), (1, 0.5, 0, 0),
    ],
    "spring": [(0, 1, 0, 1), (1, 1, 1, 0)],
    "summer": [(0, 0, 0.5, 0.4), (1, 1, 1, 0.4)],
    "autumn": [(0, 1, 0, 0), (1, 1, 1, 0)],
    "winter": [(0, 0, 0, 1), (1, 0, 1, 0.5)],
}

# the reference's public name list (colormaps.py:32-34)
REFERENCE_MAPS = (
    "metalheat", "grayscale", "grayscale2", "rainbow", "highcontrast",
    "green", "red", "blue", "plasma", "ratio", "vik",
)


def list_colormaps():
    return sorted(_MAPS.keys())


def apply_colormap(values, name: str = "grayscale"):
    """values in [0,1] (any shape) -> uint8 RGB array shaped values.shape+(3,)."""
    if name not in _MAPS:
        raise ValueError("unknown colormap %r (have: %s)" % (name, list_colormaps()))
    stops = np.array(_MAPS[name], np.float64)
    pos, rgb = stops[:, 0], stops[:, 1:]
    v = np.clip(np.asarray(values, np.float64), 0, 1)
    out = np.empty(v.shape + (3,), np.float64)
    for c in range(3):
        out[..., c] = np.interp(v, pos, rgb[:, c])
    return (out * 255).astype(np.uint8)
