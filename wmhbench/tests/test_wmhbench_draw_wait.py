"""The reader of ``train.draw_wait_ms`` on a hand-built trace: it reads the
span ``deepwmh.train.draw_wait`` by its exact name, as milliseconds a
traced step, and nothing without it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from wmhbench import harness

MS = 1_000_000  # ns
KERNELS = [(0, 10 * MS, "k"), (40 * MS, 50 * MS, "k")]
WAITS = [(12 * MS, 12 * MS + 300_000, "deepwmh.train.draw_wait"),
         (45 * MS, 45 * MS + 100_000, "deepwmh.train.draw_wait")]
OTHERS = [(0, 100 * MS, "wmhbench.unit"), (10 * MS, 20 * MS, "deepwmh.train.augment"),
          (20 * MS, 30 * MS, "deepwmh.train.data_wait"),
          (30 * MS, 31 * MS, "deepwmh.train.draw_wait_other"), (31 * MS, 32 * MS, "draw_wait")]


def ctx(host, units=2, kernels=KERNELS):
    trace = harness.Trace(0.1, sorted(kernels), sorted(host))
    return SimpleNamespace(trace=trace, traced_units=units, units=0, elapsed=0.0)


def test_reads_the_span_by_its_exact_name():
    read = harness.metric_reader("train.draw_wait_ms")
    assert read(ctx(WAITS + OTHERS)) == pytest.approx((0.3 + 0.1) / 2, rel=1e-12)


@pytest.mark.parametrize("units,kernels", [(2, KERNELS), (0, KERNELS), (2, [])])
def test_reads_nothing_without_the_span(units, kernels):
    read = harness.metric_reader("train.draw_wait_ms")
    assert read(ctx(OTHERS, units, kernels)) is None
    if units and kernels:
        assert read(ctx(WAITS + OTHERS, units, kernels)) is not None
