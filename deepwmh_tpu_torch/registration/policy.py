"""Registration mode selection: per-pair SVF optimisation or the amortised
learned network (the port of ``deepwmh_tpu.registration.policy``; the
decision logic is the JAX package's, the timing constants are the H100's).

``select_registration_mode`` resolves 'auto' from a cost model: per-pair
costs scale with volume voxels, the learned mode pays a fixed cost (first
launches, template construction and network training) that it must win
back over the pairs. Auto picks learned only where the estimated SVF total
exceeds QUALITY_INSURANCE_FACTOR x the learned total: the JAX package's
full train -> predict loop measured SVF's pairs better for the final
segmentation at small volumes and cohorts, so learned has to be much faster
to be worth it. With the H100's constants below auto picks learned from
13 pairs of 64x80x64, JAX's from 2,389: at 5 x 3 and 12 x 14 pairs
the port's default differs from JAX's, and at 5 x 3 the
card's full loop (``chip_smoke.py --e2e-dice``) read svf's held-out Dice
higher. That is fault C1, open (ROADMAP C.1). A '--distributed a/b' shard
always resolves to svf (the learned mode trains one shared network).
"""

from __future__ import annotations

# The per-pair and fixed costs, read by ``chip_smoke.py --e2e-dice`` (its
# e2e_dice_summary line; the medians of seeds 0-2) on one NVIDIA H100 80GB
# HBM3, power limit 700.00 W, inside run_train on 5 x 3 phantom pairs at
# 64x80x64 2 mm, the JAX package's e2e accuracy cohort. The card's Adam
# steps are host-bound, so a pair costs about as much at 192x224x192 (21.5
# s in the CLI, phase group_register) as here: the voxel scaling below moves
# both modes' costs together, and the decision hardly depends on the shape.
BENCH_VOXELS = 64 * 80 * 64  # the shape the costs are read at (the JAX package's name)
# svf training-prep preset, GroupRegistration.launch's wall over its 15
# pairs, artifact to artifact
T_SVF_PAIR_S = 11.82
# learned wall less template and training, over 15 pairs: forward, lift,
# resample and artifact writes
T_LEARNED_PAIR_S = 0.196
# the first training step less a later one (cuDNN's first launches; eager
# PyTorch compiles nothing)
LEARNED_FIXED_COMPILE_S = 0.092
# 10 x the template's 4.96 s a volume + 300 x 0.0636 s a training step,
# all 300 steps measured
LEARNED_FIXED_SCALED_S = 68.7
# svf must be this many times slower before auto trades away its measured
# full-loop quality edge (not a timing)
QUALITY_INSURANCE_FACTOR = 2.0


def estimated_totals_s(n_pairs: int, volume_voxels: int | None = None):
    """(svf_total_s, learned_total_s) from the cost model; volume_voxels =
    mean voxels per cohort volume, None for the shape the costs were read
    at (BENCH_VOXELS)."""
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
