"""Profiling hooks (the port's copy of ``deepwmh_tpu.utils.profiling``):
named spans on the profiler's clock, named wall-time stages with a summary
table, and a ``torch.profiler`` trace written for Perfetto /
``chrome://tracing``.

``span(name)`` is the port's one span primitive. While a ``torch.profiler``
records, it opens a host event ``deepwmh.<name>`` with kineto's own
timestamps, in the same trace and on the same clock as the kernels, so an
idle gap on the device falls under the stage the host was in. The event is
of the kind the profiler gives an operator (``_RecordFunctionFast``), not
``record_function``'s user annotation: kineto mirrors a user annotation
onto the device's timeline as a GPU event over the kernels it launched,
which a reader of the device's events would take for device work. With no
profiler recording a span costs one flag check. A span never synchronises
the device: its length is the host's time in the stage, waits on the device
inside it included. The port's span names and the metrics that read them
are listed in ``PERF.md``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

from deepwmh_tpu_torch.utils.table import render_table

PREFIX = "deepwmh."


def recording() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records: the
    flag the profiler sets for every thread while it runs. No torch
    imported means no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class span:
    """A named span (``with span("predict.n4"):`` or ``@span("nifti.read")``)
    that exists only in a profiler's trace, as ``deepwmh.<name>``."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if recording():
            from torch._C._profiler import _RecordFunctionFast

            self._rf = _RecordFunctionFast(PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def _all_threads_config():
    """A kineto config that records every thread (the prefetch workers'
    spans too), where the installed torch has one."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, where there is one, CUDA activity; every
    thread where the installed torch can) and write it as a Chrome trace,
    ``<log_dir>/trace_<pid>_<ns>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    config = _all_threads_config()
    extra = {} if config is None else {"experimental_config": config}
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **extra) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


class StageTimer:
    """Accumulates named stage durations (host wall time, seconds); renders
    a summary table. Each stage is also a ``span`` of its name."""

    def __init__(self, logger=None):
        self.durations = {}
        self.logger = logger

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if self.logger is not None:
                self.logger.write("[timing] %s: %.2fs" % (name, dt))

    def summary(self) -> str:
        rows = [(k, "%.2f s" % v) for k, v in sorted(self.durations.items())]
        return render_table(["stage", "elapsed"], rows)
