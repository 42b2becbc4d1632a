"""``train.k1_bwd_roofline`` on hand-built traces: the flagship patch's
elements and blocks from ``norm_blocks``, the share at the bytes bound, and
nothing read on a launch count other than one a block a traced step."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from wmhbench import harness
from wmhbench.arith.peaks import HBM_BYTES_PER_S
from wmhbench.arith.unet import norm_blocks

PLAN = harness.load_json(os.path.join(harness.ROOT, "wmhbench", "configs",
                                      "flagship_1mm_iso.json"))["plan"]
READ = harness.metric_reader("train.k1_bwd_roofline")
NAMES = ("void (anonymous namespace)::inorm_act_bwd_stats_kernel<__nv_bfloat16>(...)",
         "void (anonymous namespace)::inorm_act_bwd_dx_kernel<__nv_bfloat16>(...)")


def _ctx(launches, steps=2, ns=1_000_000, batch=2):
    """A trace of ``launches`` of each backward kernel, ``ns`` each, and
    one other kernel."""
    kernels = [(i * ns, (i + 1) * ns, name) for i in range(launches) for name in NAMES]
    kernels.append((0, 5 * ns, "void inorm_act_kernel<__nv_bfloat16>(...)"))
    return SimpleNamespace(trace=harness.Trace(1.0, sorted(kernels), []), traced_units=steps,
                           plan=PLAN, batch=batch)


def test_flagship_patch_elements_and_blocks():
    blocks = norm_blocks(PLAN, PLAN["patch_size"])
    assert len(blocks) == 22
    assert sum(v * c for v, c in blocks) == 446_668_800


def test_share_of_the_bytes_bound():
    steps, ns = 3, 2_000_000
    got = READ(_ctx(22 * steps, steps, ns))
    # each step: 2 samples x 446,668,800 elements x 6 bytes; 2 x 22 launches of 2 ms
    want = 100.0 * 6 * 2 * 446_668_800 * steps / HBM_BYTES_PER_S / (2 * 22 * steps * ns / 1e9)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("launches", [0, 21 * 2, 23 * 2, 30 * 2])
def test_reads_nothing_on_another_launch_count(launches):
    assert READ(_ctx(launches, steps=2)) is None


def test_reads_nothing_without_a_trace():
    assert READ(SimpleNamespace(trace=None, traced_units=0, plan=PLAN, batch=2)) is None
