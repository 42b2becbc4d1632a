"""The readers of the port's spans on a hand-built trace: seconds a unit by
the union of a name's intervals (a nested span of the same name counts
once), nothing when a span is absent, and the share of the idle gaps that
no span covers."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from wmhbench import harness, spans

MS = 1_000_000  # ns

# kernels busy over [0, 10] and [40, 50] ms, and [90, 100] overlapping
# [95, 110]: idle gaps [10, 40] and [50, 90] ms, 70 ms in all
KERNELS = [(0, 10 * MS, "k"), (40 * MS, 50 * MS, "k"), (90 * MS, 100 * MS, "k"),
           (95 * MS, 110 * MS, "k")]
HOST = [
    # a read over [5, 25] with a read nested in it and one beyond it
    (5 * MS, 25 * MS, "deepwmh.nifti.read"),
    (8 * MS, 12 * MS, "deepwmh.nifti.read"),
    (60 * MS, 70 * MS, "deepwmh.nifti.read"),
    # a write overlapping the first read: [20, 30]
    (20 * MS, 30 * MS, "deepwmh.nifti.write"),
    (30 * MS, 35 * MS, "deepwmh.predict.n4"),
    (30 * MS, 34 * MS, "deepwmh.components.label"),
    (52 * MS, 54 * MS, "deepwmh.stage1.read_wait"),
    (1 * MS, 200 * MS, "aten::to"),  # not a span of the port
    (0, 300 * MS, "wmhbench.unit"),
    (80 * MS, 84 * MS, "deepwmh.train.data_wait"),
]
UNITS = 2


def ctx(kernels=KERNELS, host=HOST, units=UNITS):
    trace = harness.Trace(0.3, sorted(kernels), sorted(host))
    return SimpleNamespace(trace=trace, traced_units=units, units=0, elapsed=0.0)


READERS = {
    # (spans' union in ms, over the units)
    "predict.io_s": (25 + 10) / 1e3 / UNITS,  # [5, 30] and [60, 70]
    "predict.n4_s": 5 / 1e3 / UNITS,
    "predict.labelling_s": 4 / 1e3 / UNITS,
    "stage1.io_s": (25 + 10 + 2) / 1e3 / UNITS,
    "stage1.labelling_s": 4 / 1e3 / UNITS,
    "train.data_wait_ms": 4 / UNITS,
}
# gaps [10, 40] and [50, 90]; spans cover [10, 35], [52, 54], [60, 70] and
# [80, 84] of them: 41 of 70 ms
UNSPANNED = 100.0 * (1 - 41 / 70)


@pytest.mark.parametrize("name,want", sorted(READERS.items()))
def test_seconds_a_unit_by_the_union_of_intervals(name, want):
    assert harness.metric_reader(name)(ctx()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cell", ["predict", "stage1", "train"])
def test_unspanned_idle_share(cell):
    read = harness.metric_reader(cell + ".unspanned_idle_share")
    assert read(ctx()) == pytest.approx(UNSPANNED, rel=1e-12)
    # the half-covered gap alone: [10, 40] is covered over [10, 35]
    assert read(ctx(kernels=KERNELS[:2])) == pytest.approx(100.0 * 5 / 30, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS) + ["predict.preview_s"])
def test_a_reader_finds_nothing_without_its_span(name):
    parent = [h for h in HOST if not h[2].startswith(spans.PREFIX)]
    assert harness.metric_reader(name)(ctx(host=parent)) is None
    assert harness.metric_reader(name)(ctx(units=0)) is None
    # a trace without kernels is no device trace (a CPU run's)
    assert harness.metric_reader(name)(ctx(kernels=[])) is None


def test_unspanned_share_needs_spans_and_gaps():
    read = harness.metric_reader("predict.unspanned_idle_share")
    assert read(ctx(host=[h for h in HOST if not h[2].startswith(spans.PREFIX)])) is None
    assert read(ctx(kernels=KERNELS[:1])) is None


def test_table_gives_each_span_and_the_idle_under_it():
    got = spans.table(ctx().trace, UNITS)
    assert set(got) == {"nifti.read", "nifti.write", "predict.n4", "components.label",
                        "stage1.read_wait", "train.data_wait"}
    # reads [5, 25] and [60, 70]: idle under them [10, 25] and [60, 70]
    assert got["nifti.read"] == pytest.approx([30 / 1e3 / UNITS, 25 / 1e3 / UNITS,
                                               3 / UNITS])
    assert got["predict.n4"] == pytest.approx([5 / 1e3 / UNITS, 5 / 1e3 / UNITS, 1 / UNITS])


def test_union_and_overlap():
    assert spans.union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3), (5, 10)]
    assert spans.overlap([(0, 3), (5, 10)], [(2, 6), (8, 20)]) == 1 + 1 + 2
    assert spans.idle_gaps(ctx().trace) == [(10 * MS, 40 * MS), (50 * MS, 90 * MS)]
