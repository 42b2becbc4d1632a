"""What the benchmark reads of the port's spans: the host events
``deepwmh.<name>`` that ``deepwmh_tpu_torch/utils/profiling.span`` opens
while a profiler records, on the same clock as the kernels of a traced
window. A span is found by its exact name.

``seconds_per_unit`` is the union of the named spans' intervals over the
traced units, so a span nested in another of the names counts once;
``unspanned_idle_share`` the share of the device's idle gaps (between
kernels, as ``Trace.idle_gaps`` sees them) that no span covers; ``table``
each span's seconds a unit, the device's idle seconds a unit under it and
its count a unit, over a traced window's ``Trace``.
"""

from __future__ import annotations

PREFIX = "deepwmh."


def union(intervals) -> list:
    """Sorted disjoint [(start, end)] covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def measure(merged) -> int:
    return sum(e - s for s, e in merged)


def overlap(xs, ys) -> int:
    """The length both of two sorted disjoint interval lists cover."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, names=None) -> list:
    """The union of the intervals of the spans named ``names`` (every
    span of the port when None)."""
    if names is None:
        return union((s, e) for s, e, n in trace.host_ops if n.startswith(PREFIX))
    full = {PREFIX + n for n in names}
    return union((s, e) for s, e, n in trace.host_ops if n in full)


def idle_gaps(trace) -> list:
    """Sorted [(start, end)] of the gaps between kernels."""
    gaps, end = [], None
    for s, e, _ in trace.kernels:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def seconds_per_unit(ctx, *names):
    """Seconds a traced unit inside any of the spans ``names``; None without
    a device trace (a trace with no kernel is a CPU run's) or without such a
    span in it."""
    if ctx.trace is None or not ctx.traced_units or not ctx.trace.kernels:
        return None
    merged = spans(ctx.trace, names)
    if not merged:
        return None
    return measure(merged) / 1e9 / ctx.traced_units


def unspanned_idle_share(ctx):
    """Percent of the idle gaps' time under no span of the port; None
    without a trace, gaps or spans."""
    if ctx.trace is None:
        return None
    gaps, covered = idle_gaps(ctx.trace), spans(ctx.trace)
    if not gaps or not covered:
        return None
    return 100.0 * (1.0 - overlap(gaps, covered) / measure(gaps))


def table(trace, units: int) -> dict:
    """{span name: [seconds a unit, idle seconds a unit under it, spans a
    unit]}."""
    gaps = idle_gaps(trace)
    counts = {}
    for *_, n in trace.host_ops:
        if n.startswith(PREFIX):
            counts[n[len(PREFIX):]] = counts.get(n[len(PREFIX):], 0) + 1
    out = {}
    for name in sorted(counts):
        merged = spans(trace, [name])
        out[name] = [measure(merged) / 1e9 / units, overlap(gaps, merged) / 1e9 / units,
                     counts[name] / units]
    return out

