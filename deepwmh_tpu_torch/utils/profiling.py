"""Profiling hooks (the port's copy of ``deepwmh_tpu.utils.profiling``):
named wall-time stages with a summary table, and a ``torch.profiler``
trace written for Perfetto / ``chrome://tracing``."""

from __future__ import annotations

import contextlib
import os
import time

from deepwmh_tpu_torch.utils.table import render_table


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, where there is one, CUDA activity) and
    write it as a Chrome trace, ``<log_dir>/trace_<pid>_<ns>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


class StageTimer:
    """Accumulates named stage durations (wall time, seconds); renders a
    summary table."""

    def __init__(self, logger=None):
        self.durations = {}
        self.logger = logger

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if self.logger is not None:
                self.logger.write("[timing] %s: %.2fs" % (name, dt))

    def summary(self) -> str:
        rows = [(k, "%.2f s" % v) for k, v in sorted(self.durations.items())]
        return render_table(["stage", "elapsed"], rows)
