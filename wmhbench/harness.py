"""The benchmark's machinery, shared by every cell: finding a cell's files
by name, the measured window, the device trace and its reduction, the
comparison against limits, and the import guard.

Nothing here knows a particular cell. A cell is a ``workloads`` entry of
``BENCHMARK.json``: its ``config`` names ``configs/<config>.json``, its
``traffic`` names ``traffic/<traffic>.json``, whose ``driver`` key names
``drivers/<driver>.py``; its limits are ``limits/<cell>.json``; each
metric, end-to-end or per-layer, is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
# top-level module names the benchmark's process must never hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "deepwmh_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # its per-layer metrics

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None, pkg_dir: str = PKG_DIR) -> Cell:
    spec = benchmark_spec() if spec is None else spec
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, ", ".join(sorted(by_name))))
    w = by_name[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(os.path.dirname(pkg_dir), cfg_entry["file"]))
    traffic = load_json(os.path.join(pkg_dir, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(pkg_dir, "limits", name + ".json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, config, traffic, limits, e2e, layer)


def driver_module(driver: str):
    return importlib.import_module("wmhbench.drivers." + driver)


def metric_module(name: str, pkg_dir: str = PKG_DIR):
    """``metrics/<name>.py`` (a name may hold dots, so the file is loaded
    by path)."""
    path = os.path.join(pkg_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("wmhbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, pkg_dir: str = PKG_DIR):
    """``metrics/<name>.py``'s ``read``."""
    return metric_module(name, pkg_dir).read


def end_to_end_reader(metric: dict, pkg_dir: str = PKG_DIR):
    """An end-to-end metric's ``read``; its file states the unit and the
    direction it computes, and an entry of BENCHMARK.json that declares
    others is refused."""
    mod = metric_module(metric["name"], pkg_dir)
    got = (getattr(mod, "UNIT", None), getattr(mod, "BETTER", None))
    if got != (metric["unit"], metric["better"]):
        raise ValueError("metrics/%s.py computes unit %r, better %r; BENCHMARK.json says %r, %r"
                         % ((metric["name"],) + got + (metric["unit"], metric["better"])))
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN_MODULES))


def derive_seed(seed: int, *keys) -> int:
    """A 31-bit seed for one use of the run's ``--seed`` (any whole number)."""
    import numpy as np

    words = [int(seed) % 2**64, int(seed) // 2**64 % 2**64]
    words += [int.from_bytes(str(k).encode(), "little") % 2**32 for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


# -- the window ------------------------------------------------------------


class StopWindow(Exception):
    """Raised from inside a driver's loop once the window has closed."""


class Window:
    """The measured window: ``begin`` closes set-up, ``unit_done`` counts a
    completed unit and says whether the window has closed, ``end`` takes the
    time of the last completed unit. With tracing, the device trace covers
    the first ``trace_units`` units of the window."""

    def __init__(self, seconds: float, t_start: float, device, trace_units: int = 0):
        self.seconds = float(seconds)
        self.t_start = t_start
        self.device = device
        self.trace_units = int(trace_units)
        self.units = 0
        self.unit_ends = []  # host clock at each unit's completion, from t0
        self.setup_s = None
        self.t0 = self.t_last = None
        self.traced_units = 0
        self.t_resume = None  # when tracing had stopped, and the units done by then
        self.units_at_resume = 0
        self._prof = self._stopped = None
        self._trace_s = None
        self._t_trace0 = None

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def begin(self):
        if self.trace_units > 0:
            self._start_trace()
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self.t0 = self.t_last = now
        self._t_trace0 = now

    def unit_done(self, synced: bool = False) -> bool:
        """One more unit completed (its work enqueued; ``synced`` when the
        host already waited for it). True once the window has closed."""
        self.units += 1
        if self._prof is not None and self.units >= self.trace_units:
            self._stop_trace()
        now = time.perf_counter()
        self.unit_ends.append(now - self.t0)
        if synced:
            self.t_last = now
        return now - self.t0 >= self.seconds

    def end(self):
        self.sync()
        self.t_last = time.perf_counter()
        if self._prof is not None:
            self._stop_trace()

    @property
    def elapsed(self) -> float:
        return self.t_last - self.t0

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def _stop_trace(self):
        self.sync()
        prof, self._prof = self._prof, None
        self._trace_s = time.perf_counter() - self._t_trace0
        prof.__exit__(None, None, None)
        self._stopped = prof
        self.traced_units = self.units
        self.t_resume = time.perf_counter()
        self.units_at_resume = self.units

    @property
    def trace(self):
        """The traced window's Trace (read once the window has closed)."""
        if self._stopped is None:
            return None
        if not isinstance(self._stopped, Trace):
            self._stopped = Trace.from_profiler(self._stopped, self._trace_s)
        return self._stopped

    def untraced_rate(self) -> tuple:
        """(units, seconds) of the window after tracing stopped: the rate
        a traced run reads without the profiler's cost; the traced part's
        when the window closed while tracing."""
        if self.t_resume is not None and self.units > self.units_at_resume:
            return self.units - self.units_at_resume, self.t_last - self.t_resume
        return self.units, self.elapsed


# -- the device trace --------------------------------------------------------


def kernel_name(full: str) -> str:
    """A device kernel's function name from the profiler's demangled
    signature: ``void inorm_stats_kernel<__nv_bfloat16>(...)`` ->
    ``inorm_stats_kernel``."""
    name = full.strip()
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    for stop in "<(":
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip()


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")()) * 1000


@dataclass
class Trace:
    """What the benchmark keeps of one traced window."""

    window_s: float
    kernels: list = field(default_factory=list)  # [(start_ns, end_ns, name)] device
    host_ops: list = field(default_factory=list)  # [(start_ns, end_ns, name)] CPU

    @staticmethod
    def from_profiler(prof, window_s: float) -> "Trace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kernels, host = [], []
        for ev in prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if ev.device_type() == cuda:
                kernels.append((start, end, ev.name()))
            else:
                host.append((start, end, ev.name()))
        kernels.sort()
        host.sort()
        return Trace(window_s, kernels, host)

    def busy_s(self) -> float:
        """Seconds in which at least one kernel ran (their union)."""
        total, cur_s, cur_e = 0, None, None
        for s, e, _ in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def device_s(self, name: str) -> float:
        """Device seconds of every kernel whose function name is ``name``."""
        return sum(e - s for s, e, n in self.kernels if kernel_name(n) == name) / 1e9

    def launches(self, name: str) -> int:
        return sum(1 for *_, n in self.kernels if kernel_name(n) == name)

    def top_kernels(self, k: int = 10) -> list:
        by = {}
        for s, e, n in self.kernels:
            key = kernel_name(n)
            by[key] = by.get(key, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps between kernels, each named by the host
        operation that overlaps it most (``python`` where none does)."""
        gaps = []
        end = None
        for s, e, _ in self.kernels:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:k]:
            best, label = 0, "python"
            for hs, he, name in self.host_ops:
                if hs >= b:
                    break
                ov = min(he, b) - max(hs, a)
                if ov > best and not name.startswith("wmhbench."):
                    best, label = ov, name
            out.append([label, length / 1e9])
        return out


# -- checks and the result -----------------------------------------------------


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number at most its limit;
    a number that is missing or not finite fails."""
    import math

    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    base = os.path.join(root, ".wmhbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
