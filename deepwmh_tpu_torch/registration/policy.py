"""Registration mode selection: per-pair SVF optimisation or the amortised
learned network (the port of ``deepwmh_tpu.registration.policy``; the
decision logic is the JAX package's, the timing constants are the H100's).

``select_registration_mode`` resolves 'auto' from a cost model: per-pair
costs scale with volume voxels, the learned mode pays a fixed cost (first
launches, template construction and network training) that it must win
back over the pairs. Auto picks learned only where the estimated SVF total
exceeds QUALITY_INSURANCE_FACTOR x the learned total: the full
train -> predict loop has measured SVF's pairs better for the final
segmentation at small volumes and cohorts, so learned has to be much faster
to be worth it. A '--distributed a/b' shard always resolves to svf (the
learned mode trains one shared network).
"""

from __future__ import annotations

# The per-pair and fixed costs, read by chip_smoke.py (phases group_register
# and learned; its policy_readings line) on one NVIDIA H100 80GB HBM3, power
# limit 700.00 W, at 192x224x192 1 mm on a 2 x 2 cohort:
BENCH_VOXELS = 192 * 224 * 192  # the shape the per-pair costs are measured at
# training-prep preset, the CLI's wall over its four pairs, artifact to
# artifact (its start included)
T_SVF_PAIR_S = 21.5
# learned wall less template and training, over four pairs: forward, lift,
# resample and artifact writes
T_LEARNED_PAIR_S = 5.02
# the first training step less a later one (cuDNN's first launches; eager
# PyTorch compiles nothing)
LEARNED_FIXED_COMPILE_S = 0.41
# 10 x the template's 8.25 s a volume + 300 x 0.104 s a training step, the
# step time extrapolated from 30 steps
LEARNED_FIXED_SCALED_S = 113.7
# svf must be this many times slower before auto trades away its measured
# full-loop quality edge (not a timing)
QUALITY_INSURANCE_FACTOR = 2.0


def estimated_totals_s(n_pairs: int, volume_voxels: int | None = None):
    """(svf_total_s, learned_total_s) from the cost model; volume_voxels =
    mean voxels per cohort volume, None for the bench shape."""
    s = 1.0 if volume_voxels is None else max(float(volume_voxels) / BENCH_VOXELS, 1e-3)
    svf = T_SVF_PAIR_S * s * n_pairs
    learned = (LEARNED_FIXED_COMPILE_S + LEARNED_FIXED_SCALED_S * s
               + T_LEARNED_PAIR_S * s * n_pairs)
    return svf, learned


def select_registration_mode(n_sources: int, n_targets: int, mode: str = "auto",
                             distributed: str | None = None,
                             volume_voxels: int | None = None) -> str:
    """Resolve 'auto' to 'svf' or 'learned' (module docstring); an explicit
    'svf' / 'learned' always wins."""
    if mode not in ("auto", "svf", "learned"):
        raise ValueError("registration mode must be auto/svf/learned, got %r" % mode)
    if mode != "auto":
        return mode
    if distributed is not None:
        return "svf"
    svf_s, learned_s = estimated_totals_s(int(n_sources) * int(n_targets), volume_voxels)
    return "learned" if svf_s > QUALITY_INSURANCE_FACTOR * learned_s else "svf"
