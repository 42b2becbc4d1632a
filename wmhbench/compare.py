"""The comparisons that decide ``correct``: how far what the timed path
produced lies from the plain reference, as numbers that limits hold."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's is nought to rounding (a conv bias under instance norm): its change
# is round-off alone and is left out of the change comparison
NOUGHT_GRAD_SHARE = 1e-3


def _norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def leaf_gaps(got, want) -> list:
    """Each leaf's gap of norms, | ||got|| - ||want|| |, over the larger of
    ||want|| and the median leaf's ||want||."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w)
    return [abs(a - b) / max(b, med, 1e-30) for a, b in zip(g, w)]


def worst_leaf_gap(got, want, keep=None) -> float:
    """The largest leaf's gap over the leaves ``keep`` selects."""
    gaps = [v for i, v in enumerate(leaf_gaps(got, want)) if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def median_leaf_gap(got, want, keep=None) -> float:
    """The median leaf's gap over the leaves ``keep`` selects."""
    gaps = [v for i, v in enumerate(leaf_gaps(got, want)) if keep is None or keep[i]]
    return statistics.median(gaps) if gaps else 0.0


def moving_leaves(ref_grads) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    n = _norms(ref_grads)
    med = statistics.median(n)
    return [v >= NOUGHT_GRAD_SHARE * med for v in n]


def max_abs(got, want) -> float:
    return max((float((a.double() - b.double()).abs().max()) if a.numel() else 0.0)
               for a, b in zip(got, want))


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    scale = float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30)


def mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of voxels whose binary labels differ."""
    return float(((got > 0.5) != (want > 0.5)).double().mean())


# a voxel whose reference foreground probability lies at least this far from
# the 0.5 threshold is decided by the model, not by rounding: a bfloat16
# sweep moves the probability by less (nearly every flip of a sound run on
# the card lies within it), a float8 one by more
DECISIVE_MARGIN = 0.01


def decisive_per_near(got: torch.Tensor, want: torch.Tensor, prob: torch.Tensor) -> float:
    """Voxels whose binary labels differ although the reference
    probability ``prob`` lies at least DECISIVE_MARGIN from 0.5, per voxel
    that lies nearer than that (those that rounding may flip): steady from
    seed to seed, where a plain share of voxels follows how many voxels a
    seed's random network leaves near the threshold."""
    decisive = (prob - 0.5).abs() >= DECISIVE_MARGIN
    differ = (got > 0.5) != (want > 0.5)
    near = (~decisive).double().sum().clamp(min=1)
    return float((differ & decisive).double().sum() / near)
