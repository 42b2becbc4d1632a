"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their build.

Each kernel lives in ``deepwmh_tpu_torch/csrc/<name>.cu`` with a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library under ``deepwmh_tpu_torch/_build/`` (named by a hash of
the source, the headers of ``csrc/`` and the flags, so an edit rebuilds) and
loaded with ``ctypes``. Nothing is built or loaded at import time. K1 is two
kernels: the statistics and the pass that applies them; its backward is two
more (``instance_norm_act_backward.cu``), which ``instance_norm_act_fn``, a
``torch.autograd.Function``, puts behind K1's forward.

A wrapper takes its kernel's plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises. Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import math
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

from deepwmh_tpu_torch.utils.profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found on PATH or under %s/bin" % home)
    return path


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: keyed by the source, the headers
    of ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".h"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (stem, digest.hexdigest()[:16]))


def build(sources) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns {source: library path}; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``; the wait on the compilers is the
    span ``kernels.build``. Raises if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for source in sources:
        out = library_path(source)
        if os.path.isfile(out):
            continue
        tmp = "%s.tmp-%d-%d" % (out, os.getpid(), threading.get_ident())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, out))
    failed = []
    with span("kernels.build"):
        for source, proc, tmp, out in running:
            log, _ = proc.communicate()
            with open(os.path.splitext(out)[0] + ".log", "w") as f:
                f.write(log)
            if proc.returncode:
                failed.append("%s:\n%s" % (source, log))
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return {s: library_path(s) for s in sources}


class CudaKernel:
    """A kernel in its own shared library, built and loaded at first use."""

    source = ""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    def _bind(self, lib) -> None:
        raise NotImplementedError

    def _count(self) -> None:
        """One more launch; callers on several threads (stage-1 over a mesh
        of cards runs a thread a card) lose no count."""
        with self._count_lock:
            self.launches += 1

    def lib(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build([self.source])[self.source])
                self._bind(lib)
                self._lib = lib
        return self._lib


# ---------------------------------------------------------------------- #
# K1: instance-norm statistics
# ---------------------------------------------------------------------- #


def instance_norm_stats_reference(x: torch.Tensor):
    """Plain version of K1: per-(sample, channel) mean and raw fast
    variance E[x^2] - E[x]^2 of ``x`` [N, *spatial, C], in f32."""
    xf = x.float()
    axes = tuple(range(1, x.dim() - 1))
    mean = xf.mean(axes)
    var = (xf * xf).mean(axes) - mean * mean
    return mean, var


class _ChannelsLastKernel(CudaKernel):
    """K1's two kernels read a contiguous [N, *spatial, C] view (the
    permuted view of a channels-last activation) with 16-byte loads: a block
    is ``rows`` rows x C/V threads (V elements in 16 bytes), a grid of (G, N)
    blocks, G sized to one wave of resident blocks and to at least
    MIN_ROWS_PER_THREAD rows a thread. Narrow widths (C < V with V % C == 0:
    C = 1, 2, 4 in bf16 and 1, 2 in f32) walk each sample's flat run as
    16-byte vectors, a vector a row and THREADS rows a block. The geometry
    of a shape is worked out once and kept."""

    name = ""
    THREADS = 256
    MIN_ROWS_PER_THREAD = 8
    MAX_SHARED = 48 * 1024

    def __init__(self):
        super().__init__()
        self._plans = {}
        self._sms = {}

    def _shared_bytes(self, threads, rows, N, C) -> int:
        return 0

    def _blocks_per_sm(self, lib, bf16, N, C, rows) -> int:
        raise NotImplementedError

    def _plan(self, x: torch.Tensor):
        """(N, M, C, rows, G, launch function) for ``x``'s shape, dtype and
        device; raises ValueError for what the kernel cannot read."""
        key = (x.shape, x.dtype, x.device)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        name = self.name
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("%s: dtype %s not supported" % (name, x.dtype))
        if x.dim() < 3:
            raise ValueError("%s: need a contiguous [N, *spatial, C] view (shape %s)"
                             % (name, tuple(x.shape)))
        N, C = int(x.shape[0]), int(x.shape[-1])
        M = x.numel() // max(N * C, 1)
        vec = 16 // x.element_size()
        narrow = 0 < C < vec
        if N == 0 or M == 0 or (vec % C if narrow else C % vec):
            raise ValueError("%s: need N, M > 0 and C %% %d == 0 or %d %% C == 0 "
                             "(N=%d M=%d C=%d)" % (name, vec, vec, N, M, C))
        groups = 1 if narrow else C // vec
        units = -(-M * C // vec) if narrow else M  # the rows the blocks walk
        rows = max(1, self.THREADS // groups)
        threads = rows * groups
        if threads > 1024 or self._shared_bytes(threads, rows, N, C) > self.MAX_SHARED:
            raise ValueError("%s: C=%d (N=%d) too wide" % (name, C, N))
        lib = self.lib()
        bf16 = x.dtype == torch.bfloat16
        with torch.cuda.device(x.device):
            if x.device not in self._sms:
                self._sms[x.device] = torch.cuda.get_device_properties(
                    x.device).multi_processor_count
            per_sm = self._blocks_per_sm(lib, int(bf16), N, C, rows)
        if per_sm < 1:
            raise ValueError("%s: C=%d (N=%d) cannot launch" % (name, C, N))
        G = max(1, min(-(-units // (rows * self.MIN_ROWS_PER_THREAD)),
                       self._sms[x.device] * per_sm // N))
        plan = (N, M, C, rows, G, self._launch_fn(lib, bf16))
        self._plans[key] = plan
        return plan

    def _launch_fn(self, lib, bf16):
        raise NotImplementedError

    def _refuse_autograd(self, *tensors) -> None:
        """A wrapper has no backward of its own: a call that autograd would
        have to see through raises, on the CPU too, so that nothing trains
        on the plain version unnoticed. ``instance_norm_act_fn`` is K1 with
        its backward."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise RuntimeError("%s: the CUDA kernel has no backward; call it under "
                               "torch.no_grad() or torch.inference_mode(), or "
                               "differentiate instance_norm_act_fn" % self.name)

    def _check_view(self, x: torch.Tensor) -> None:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                "%s: need a contiguous, 16-byte aligned [N, *spatial, C] view "
                "(shape %s, strides %s)" % (self.name, tuple(x.shape), x.stride()))


def _current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_device(device: torch.device, fn, *args) -> int:
    """``fn(*args)`` with ``device`` current, entering its context only
    when it is not the current one already."""
    if device.index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


class _TwoLevelSum(_ChannelsLastKernel):
    """A kernel that sums per (sample, channel) over a [N, *spatial, C]
    view in one launch: block partials, then the two-level sum elected by
    tickets, in a fixed order (K1's statistics and the backward's sums).
    The partials go to a workspace kept per device and stream, grown when
    needed and never freed per call."""

    MIN_ROWS_PER_THREAD = 16  # fewer partials to add up at the deep stages

    def __init__(self):
        super().__init__()
        self._workspace = {}  # (device, stream) -> (partials, group sums, tickets)

    def _shared_bytes(self, threads, rows, N, C) -> int:
        # the rows' sums in f32, then a summing block's slices in double
        return max(2 * rows * C * 4, 2 * max(threads, N * C) * 8)

    @staticmethod
    def group_blocks(G: int) -> int:
        """Blocks per group of the two-level sum: about sqrt(G)."""
        return math.isqrt(G - 1) + 1 if G > 1 else 1

    def _scratch(self, device, stream, N, G, C, groups):
        """(block partials f32, group sums f64, tickets) of one stream,
        grown when a call needs more, never freed per call. Tickets are 0
        between calls: each is reset by the block it elects."""
        ws = self._workspace.get((device, stream))
        if (ws is None or ws[0].numel() < N * G * 2 * C
                or ws[1].numel() < N * groups * 2 * C or ws[2].numel() < groups + 1):
            ws = (torch.empty(N * G * 2 * C, dtype=torch.float32, device=device),
                  torch.empty(N * groups * 2 * C, dtype=torch.float64, device=device),
                  torch.zeros(groups + 1, dtype=torch.int32, device=device))
            self._workspace[(device, stream)] = ws
        return ws

    def _scratch_args(self, dev, stream, N, G, C):
        """(partials, group sums, tickets, blocks a group) pointers for one
        launch on ``stream``."""
        per_group = self.group_blocks(G)
        partial, group_sum, ticket = self._scratch(dev, stream, N, G, C, -(-G // per_group))
        return partial.data_ptr(), group_sum.data_ptr(), ticket.data_ptr(), per_group


class InstanceNormStats(_TwoLevelSum):
    """K1 (replaces deepwmh_tpu/ops/pallas_kernels.py
    instance_norm_stats_pallas). ``x`` [N, *spatial, C] bf16 or f32 ->
    (mean, var) f32 [N, C] (two views of one [2, N, C] tensor), var
    unclamped. On CUDA ``x`` must be contiguous (a channels-last
    activation's permuted view is), 16-byte aligned, with C a multiple or a
    divisor of 16 bytes' worth of elements. One launch on the current stream, no
    synchronisation."""

    name = "instance_norm_stats"
    source = "instance_norm_stats.cu"

    def _bind(self, lib) -> None:
        for fn in (lib.inorm_stats_bf16, lib.inorm_stats_f32):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.inorm_stats_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.inorm_stats_blocks_per_sm.restype = ctypes.c_int

    def _blocks_per_sm(self, lib, bf16, N, C, rows) -> int:
        return lib.inorm_stats_blocks_per_sm(bf16, N, C, rows)

    def _launch_fn(self, lib, bf16):
        return lib.inorm_stats_bf16 if bf16 else lib.inorm_stats_f32

    def __call__(self, x: torch.Tensor):
        # the common case in few Python steps: at the deep stages the call
        # costs the host more than the card
        dev = x.device
        self._refuse_autograd(x)
        if dev.type != "cuda":
            if dev.type == "cpu":
                return instance_norm_stats_reference(x)
            raise ValueError("instance_norm_stats: unsupported device %s" % dev)
        N, M, C, rows, G, fn = self._plans.get((x.shape, x.dtype, dev)) or self._plan(x)
        self._check_view(x)
        stream = _current_stream(dev)
        partial, group_sum, ticket, per_group = self._scratch_args(dev, stream, N, G, C)
        stats = torch.empty((2, N, C), dtype=torch.float32, device=dev)
        out = stats.data_ptr()
        err = _on_device(dev, fn, x.data_ptr(), partial, group_sum, ticket, out,
                         out + N * C * 4, N, M, C, rows, G, per_group, 1.0 / M, stream)
        if err:
            raise RuntimeError("instance_norm_stats: launch failed, CUDA error %d" % err)
        self._count()
        return stats.unbind(0)


instance_norm_stats = InstanceNormStats()


def _per_sample(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N, C] or [C] -> broadcastable against ``x`` [N, *spatial, C]."""
    n = t.shape[0] if t.dim() == 2 else 1
    return t.reshape((n,) + (1,) * (x.dim() - 2) + (t.shape[-1],))


def instance_norm_act_reference(x, mean, mul, bias, slope: float):
    """Plain version of K1's apply pass: ``leaky_relu(cast(((x - mean) *
    mul) + bias))`` of ``x`` [N, *spatial, C] in f32, one rounding per
    step, cast back to ``x``'s dtype, then the leaky ReLU with ``slope`` (as
    that dtype holds it). ``mean``, ``mul`` f32 [N, C]; ``bias`` f32 [N, C]
    or [C]. The chain ConvNormAct ran before the pass became a kernel."""
    z = x.to(torch.float32, copy=True)
    z.sub_(_per_sample(mean, x)).mul_(_per_sample(mul, x)).add_(_per_sample(bias, x))
    return F.leaky_relu(z.to(x.dtype), slope)


class InstanceNormAct(_ChannelsLastKernel):
    """K1's apply pass (with K1, the redesign of deepwmh_tpu/ops/
    pallas_kernels.py instance_norm_stats_pallas for the card):
    ``instance_norm_act_reference`` in one pass. ``x`` [N, *spatial, C] bf16
    or f32 under K1's layout rules -> a new contiguous tensor of ``x``'s
    shape and dtype, with the plain version's bits."""

    name = "instance_norm_act"
    source = "instance_norm_act.cu"

    def _bind(self, lib) -> None:
        for fn in (lib.inorm_act_bf16, lib.inorm_act_f32):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.inorm_act_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.inorm_act_blocks_per_sm.restype = ctypes.c_int

    def _blocks_per_sm(self, lib, bf16, N, C, rows) -> int:
        return lib.inorm_act_blocks_per_sm(bf16, C, rows)

    def _launch_fn(self, lib, bf16):
        return lib.inorm_act_bf16 if bf16 else lib.inorm_act_f32

    def __call__(self, x, mean, mul, bias, slope: float):
        dev = x.device
        self._refuse_autograd(x, mean, mul, bias)
        if dev.type != "cuda":
            if dev.type == "cpu":
                return instance_norm_act_reference(x, mean, mul, bias, slope)
            raise ValueError("instance_norm_act: unsupported device %s" % dev)
        N, M, C, rows, G, fn = self._plans.get((x.shape, x.dtype, dev)) or self._plan(x)
        self._check_view(x)
        _check_per_channel(self.name, dev, N, C, mean=mean, mul=mul, bias=bias)
        out = torch.empty_like(x)
        err = _on_device(dev, fn, x.data_ptr(), out.data_ptr(), mean.data_ptr(),
                         mul.data_ptr(), bias.data_ptr(), C if bias.dim() == 2 else 0, N, M,
                         C, rows, G, slope, _current_stream(dev))
        if err:
            raise RuntimeError("instance_norm_act: launch failed, CUDA error %d" % err)
        self._count()
        return out


instance_norm_act = InstanceNormAct()


def _check_per_channel(name, dev, N, C, **tensors) -> None:
    """Each of ``tensors`` a contiguous f32 [N, C] tensor on ``dev``;
    ``bias`` may also be [C]."""
    for what, t in tensors.items():
        shapes = ((N, C), (C,)) if what == "bias" else ((N, C),)
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) not in shapes or not t.is_contiguous()):
            raise ValueError("%s: %s must be a contiguous f32 %s tensor on %s (got %s %s on %s)"
                             % (name, what, " or ".join(map(str, shapes)), dev, t.dtype,
                                tuple(t.shape), t.device))


# ---------------------------------------------------------------------- #
# K1's backward: the sums over each (sample, channel), then dx
# ---------------------------------------------------------------------- #


def _backward_g(x, dy, mean, mul, bias, slope: float):
    """(g, x - mean) of the backward in f32 (f64 for f64 ``x``): the
    pre-activation as the apply pass rounds it, then the leaky ReLU's
    backward in ``x``'s dtype (the cast's backward is exact)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(ct) - _per_sample(mean, x)
    z = (xc * _per_sample(mul, x) + _per_sample(bias, x)).to(x.dtype)
    g = torch.where(z > 0, dy, (dy.to(ct) * slope).to(x.dtype))
    return g.to(ct), xc


def instance_norm_act_bwd_stats_reference(x, dy, mean, mul, bias, var, slope: float,
                                          eps: float):
    """Plain version of the backward's first pass: from the sums of g and
    of g * (x - mean) over each (sample, channel) of ``x``, ``dy`` [N,
    *spatial, C], the dx pass's terms k1 = sum(g) / M and k2 = [var >= 0] *
    rstd^2 * sum(g * (x - mean)) / M [N, C] and the weight's and bias's
    gradients, sums over the samples of sum(g * x^) and of sum(g) [C]; in
    f32 (f64 for f64 ``x``). ``mean``, ``mul``, ``bias`` as the apply pass
    takes them, ``var`` K1's raw variance, rstd = rsqrt(max(var, 0) + eps)."""
    g, xc = _backward_g(x, dy, mean, mul, bias, slope)
    axes = tuple(range(1, x.dim() - 1))
    m = x.numel() // (x.shape[0] * x.shape[-1])
    sum_g, sum_gxc = g.sum(axes), (g * xc).sum(axes)
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    sum_gxhat = sum_gxc * rstd
    k2 = torch.where(var >= 0, sum_gxhat * rstd / m, 0.0)
    return sum_g / m, k2, sum_gxhat.sum(0), sum_g.sum(0)


def instance_norm_act_bwd_dx_reference(x, dy, mean, mul, bias, k1, k2, slope: float):
    """Plain version of the backward's dx pass: ``cast(mul * ((g - k1) -
    (x - mean) * k2))``, one rounding a step; ``k1``, ``k2`` [N, C]."""
    g, xc = _backward_g(x, dy, mean, mul, bias, slope)
    t = (g - _per_sample(k1, x)) - xc * _per_sample(k2, x)
    return (t * _per_sample(mul, x)).to(x.dtype)


class InstanceNormActBwdStats(_TwoLevelSum):
    """The backward of K1's chain, first pass (replaces no TPU kernel; see
    ``csrc/instance_norm_act_backward.cu``): ``instance_norm_act_bwd_stats_
    reference`` in one launch, its sums in a fixed order (two calls give
    the same bits) and its [N, C] terms in double. ``x`` and ``dy`` [N,
    *spatial, C] under K1's layout rules, the forward's ``mean``, ``mul``,
    ``var`` f32 [N, C] and ``bias`` [N, C] or [C] -> (k1, k2 [N, C], d
    weight, d bias [C]) f32, views of one tensor. The workspace as K1's
    statistics'."""

    name = "instance_norm_act_bwd_stats"
    source = "instance_norm_act_backward.cu"

    def _bind(self, lib) -> None:
        for fn in (lib.inorm_act_bwd_stats_bf16, lib.inorm_act_bwd_stats_f32):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.inorm_act_bwd_stats_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.inorm_act_bwd_stats_blocks_per_sm.restype = ctypes.c_int

    def _blocks_per_sm(self, lib, bf16, N, C, rows) -> int:
        return lib.inorm_act_bwd_stats_blocks_per_sm(bf16, N, C, rows)

    def _launch_fn(self, lib, bf16):
        return lib.inorm_act_bwd_stats_bf16 if bf16 else lib.inorm_act_bwd_stats_f32

    def __call__(self, x, dy, mean, mul, bias, var, slope: float, eps: float):
        dev = x.device
        self._refuse_autograd(x, dy, mean, mul, bias, var)
        if dev.type != "cuda":
            if dev.type == "cpu":
                return instance_norm_act_bwd_stats_reference(x, dy, mean, mul, bias, var,
                                                             slope, eps)
            raise ValueError("%s: unsupported device %s" % (self.name, dev))
        N, M, C, rows, G, fn = self._plans.get((x.shape, x.dtype, dev)) or self._plan(x)
        _check_pair(self, x, dy)
        _check_per_channel(self.name, dev, N, C, mean=mean, mul=mul, bias=bias, var=var)
        stream = _current_stream(dev)
        partial, group_sum, ticket, per_group = self._scratch_args(dev, stream, N, G, C)
        terms = torch.empty(2 * N * C + 2 * C, dtype=torch.float32, device=dev)
        err = _on_device(dev, fn, x.data_ptr(), dy.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                         bias.data_ptr(), C if bias.dim() == 2 else 0, partial, group_sum,
                         ticket, var.data_ptr(), terms.data_ptr(), N, M, C, rows, G, per_group,
                         slope, eps, stream)
        if err:
            raise RuntimeError("%s: launch failed, CUDA error %d" % (self.name, err))
        self._count()
        k, params = terms[:2 * N * C].view(2, N, C), terms[2 * N * C:].view(2, C)
        return k[0], k[1], params[0], params[1]


class InstanceNormActBwdDx(_ChannelsLastKernel):
    """The backward of K1's chain, second pass:
    ``instance_norm_act_bwd_dx_reference`` in one pass, with its bits.
    ``x``, ``dy`` [N, *spatial, C] under K1's layout rules -> dx, a new
    contiguous tensor of ``x``'s shape and dtype."""

    name = "instance_norm_act_bwd_dx"
    source = "instance_norm_act_backward.cu"

    def _bind(self, lib) -> None:
        for fn in (lib.inorm_act_bwd_dx_bf16, lib.inorm_act_bwd_dx_f32):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.inorm_act_bwd_dx_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.inorm_act_bwd_dx_blocks_per_sm.restype = ctypes.c_int

    def _blocks_per_sm(self, lib, bf16, N, C, rows) -> int:
        return lib.inorm_act_bwd_dx_blocks_per_sm(bf16, C, rows)

    def _launch_fn(self, lib, bf16):
        return lib.inorm_act_bwd_dx_bf16 if bf16 else lib.inorm_act_bwd_dx_f32

    def __call__(self, x, dy, mean, mul, bias, k1, k2, slope: float):
        dev = x.device
        self._refuse_autograd(x, dy, mean, mul, bias, k1, k2)
        if dev.type != "cuda":
            if dev.type == "cpu":
                return instance_norm_act_bwd_dx_reference(x, dy, mean, mul, bias, k1, k2, slope)
            raise ValueError("%s: unsupported device %s" % (self.name, dev))
        N, M, C, rows, G, fn = self._plans.get((x.shape, x.dtype, dev)) or self._plan(x)
        _check_pair(self, x, dy)
        _check_per_channel(self.name, dev, N, C, mean=mean, mul=mul, bias=bias, k1=k1, k2=k2)
        dx = torch.empty_like(x)
        err = _on_device(dev, fn, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), mean.data_ptr(),
                         mul.data_ptr(), bias.data_ptr(), C if bias.dim() == 2 else 0,
                         k1.data_ptr(), k2.data_ptr(), N, M, C, rows, G, slope,
                         _current_stream(dev))
        if err:
            raise RuntimeError("%s: launch failed, CUDA error %d" % (self.name, err))
        self._count()
        return dx


def _check_pair(kernel, x, dy) -> None:
    """``x`` and ``dy`` readable by ``kernel``: the same shape, dtype and
    device, each contiguous and 16-byte aligned."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("%s: dy must match x (got %s %s on %s, x %s %s on %s)"
                         % (kernel.name, tuple(dy.shape), dy.dtype, dy.device,
                            tuple(x.shape), x.dtype, x.device))
    kernel._check_view(x)
    kernel._check_view(dy)


instance_norm_act_bwd_stats = InstanceNormActBwdStats()
instance_norm_act_bwd_dx = InstanceNormActBwdDx()


def _norm_act_backward(stats_fn, dx_fn, x, dy, mean, var, mul, bias, slope, eps):
    """(dx, d weight, d bias) of K1's chain from the forward's statistics
    and multiplier, by autograd's rules through the plain chain (var's
    clamp passes the gradient where var >= 0): ``stats_fn`` gives the dx
    pass's [N, C] terms and the parameters' gradients, ``dx_fn`` dx."""
    k1, k2, d_weight, d_bias = stats_fn(x, dy, mean, mul, bias, var, slope, eps)
    return dx_fn(x, dy, mean, mul, bias, k1, k2, slope), d_weight, d_bias


def instance_norm_act_backward_reference(x, dy, mean, var, mul, bias, slope: float,
                                         eps: float):
    """Plain version of K1's backward: (dx, d weight, d bias) of K1's
    forward (``instance_norm_act_fn``) given its output's gradient ``dy``,
    from the forward's ``mean``, ``var`` and ``mul`` = rsqrt(max(var, 0) +
    eps) * weight [N, C]: dx = cast(mul * (g - mean(g) - x^ * mean(g *
    x^))) with x^ the normalised x, d weight = sum over samples of sum(g *
    x^), d bias of sum(g). In f32 (f64 for f64 ``x``)."""
    return _norm_act_backward(instance_norm_act_bwd_stats_reference,
                              instance_norm_act_bwd_dx_reference, x, dy, mean, var, mul,
                              bias, slope, eps)


def instance_norm_act_backward(x, dy, mean, var, mul, bias, slope: float, eps: float):
    """``instance_norm_act_backward_reference`` on the backward's two
    kernels (their plain versions on the CPU): two launches."""
    return _norm_act_backward(instance_norm_act_bwd_stats, instance_norm_act_bwd_dx, x, dy,
                              mean, var, mul, bias, slope, eps)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _InstanceNormActFn(torch.autograd.Function):
    """K1 forward and K1's backward kernels as one differentiable op. Saves
    ``x`` (the conv output, bf16 in training) and the f32 [N, C] ``mean``,
    ``var`` and ``mul``: nothing f32 of the activation's size."""

    @staticmethod
    def forward(ctx, x, weight, bias, slope, eps):
        # flax GroupNorm's order: var clamped at 0, then one apply pass
        mean, var = instance_norm_stats(x)
        mul = torch.rsqrt(var.clamp_min(0.0) + eps) * weight
        out = instance_norm_act(x, mean, mul, bias, slope)
        ctx.save_for_backward(x, mean, var, mul, bias)
        ctx.slope, ctx.eps = slope, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mean, var, mul, bias = ctx.saved_tensors
        grads = instance_norm_act_backward(x, _aligned(dout), mean, var, mul, bias, ctx.slope,
                                           ctx.eps)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None, None)


def instance_norm_act_fn(x, weight, bias, slope: float, eps: float):
    """K1 on ``x`` [N, *spatial, C] (the statistics, then the apply pass
    with ``mul = rsqrt(max(var, 0) + eps) * weight``, flax GroupNorm's
    order), as autograd differentiates it: K1's two kernels forward, the
    backward's two kernels (``instance_norm_act_backward``) for ``x``,
    ``weight`` [C] and ``bias`` [C]. On the CPU every step takes its plain
    version."""
    return _InstanceNormActFn.apply(x, weight, bias, slope, eps)


# ---------------------------------------------------------------------- #
# K2: 3x3x3 median
# ---------------------------------------------------------------------- #


def median3_reference(vol: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the 3x3x3 median of ``vol`` [D, H, W] (or of
    each volume of a batch [B, D, H, W]) with zeros outside each volume, in
    f32: the 27 shifted views of the zero-padded volumes stacked on a
    leading axis, sorted, rank 13."""
    D, H, W = vol.shape[-3:]
    padded = F.pad(vol.float(), (1, 1, 1, 1, 1, 1))
    win = torch.stack([padded[..., dz:dz + D, dy:dy + H, dx:dx + W]
                       for dz in range(3) for dy in range(3) for dx in range(3)])
    return torch.sort(win, dim=0).values[13]


def _live_minmax(ces, needed) -> int:
    """min/max instructions of a compare-exchange list once the exchanges
    whose outputs never reach the ``needed`` wires are removed, as the
    compiler removes them (a live exchange costs one instruction per output
    still needed)."""
    needed, ops = set(needed), 0
    for i, j in reversed(ces):
        live = len({i, j} & needed)
        if live:
            ops += live
            needed |= {i, j}
    return ops


def median27_minmax_ops() -> int:
    """min/max instructions per voxel of the first K2 design:
    _median27's 27-pass odd-even transposition network on one voxel's 27
    values, pruned to what reaches rank 13. The yardstick of K2's bound."""
    n = 27
    return _live_minmax([(i, i + 1) for p in range(n) for i in range(p % 2, n - 1, 2)], {13})


# K2's selection scheme, written once here. csrc/median27_network.h is
# generated from it (median27_header) and a CPU test proves on every 0/1
# input that the composition below selects rank 13 of 27. A compare-exchange
# (i, j) leaves the min on wire i and the max on wire j.
#
# Per output voxel (dz, dy, dx index its 3x3x3 window):
# 1. column: each 3-value column along y (fixed dz, dx) is sorted;
# 2. slab: the three sorted columns of one z-plane (dx = 0, 1, 2 on wires
#    0-2, 3-5, 6-8) are merged into one sorted 9-list;
# 3. pair: two sorted slabs (wires 0-8 and 9-17) are merged; only ranks
#    MEDIAN27_PAIR_RANKS of the 18 are kept;
# 4. select: rank 13 of the pair's 18 and the third slab's 9 is
#    max(pair[4], max_i min(pair[i], slab[13 - i])) for i = 5..13.
# In the kernel a column is sorted once and shared by the three outputs
# along x whose windows hold it, a slab once for the three along z, and a
# pair once for two outputs (planes z, z+1 with z-1 for one, z+2 for the
# other).


def _odd_even_merge(a, b, ces) -> list:
    """Batcher's odd-even merge of the sorted wire lists ``a`` and ``b`` of
    any lengths: appends its compare-exchanges to ``ces`` and returns the
    wires in sorted order."""
    if not a or not b:
        return list(a) + list(b)
    if len(a) == 1 and len(b) == 1:
        ces.append((a[0], b[0]))
        return [a[0], b[0]]
    even = _odd_even_merge(a[0::2], b[0::2], ces)
    odd = _odd_even_merge(a[1::2], b[1::2], ces)
    rest = [w for pair in itertools.zip_longest(odd, even[1:]) for w in pair if w is not None]
    ces.extend((rest[t], rest[t + 1]) for t in range(0, len(rest) - 1, 2))
    return [even[0]] + rest


def _merge_network(*lists):
    ces = []
    order = list(lists[0])
    for more in lists[1:]:
        order = _odd_even_merge(order, list(more), ces)
    return tuple(ces), tuple(order)


MEDIAN27_COLUMN = ((0, 1), (1, 2), (0, 1))
MEDIAN27_SLAB, MEDIAN27_SLAB_ORDER = _merge_network(range(0, 3), range(3, 6), range(6, 9))
MEDIAN27_PAIR, MEDIAN27_PAIR_ORDER = _merge_network(range(0, 9), range(9, 18))
MEDIAN27_PAIR_RANKS = tuple(range(4, 14))
MEDIAN27_SELECT_FLOOR = 4  # pair rank that needs no min
MEDIAN27_SELECT_TERMS = tuple((i, 13 - i) for i in range(5, 14))  # (pair rank, slab rank)


def median27_shared_ops() -> dict:
    """min/max instructions of each step of K2's shared scheme, and per
    output voxel in the steady state of a thread's walk along z: per z-plane
    two column sorts (its own column and the warp-edge halo column) and one
    slab merge, half a pair merge, one select."""
    ops = {
        "column": _live_minmax(MEDIAN27_COLUMN, range(3)),
        "slab": _live_minmax(MEDIAN27_SLAB, range(9)),
        "pair": _live_minmax(MEDIAN27_PAIR, [MEDIAN27_PAIR_ORDER[r] for r in MEDIAN27_PAIR_RANKS]),
        "select": 2 * len(MEDIAN27_SELECT_TERMS),
    }
    ops["plane"] = 2 * ops["column"] + ops["slab"]
    ops["per_output"] = ops["plane"] + ops["pair"] / 2 + ops["select"]
    return ops


def _c_ces(ces, wires: str) -> list:
    return ["  m27_ce(%s[%d], %s[%d]);" % (wires, i, wires, j) for i, j in ces]


def median27_header() -> str:
    """The text of csrc/median27_network.h, generated from the lists above."""
    pair = [MEDIAN27_PAIR_ORDER[r] for r in MEDIAN27_PAIR_RANKS]
    lines = [
        "// K2's selection scheme as device functions. Generated from the lists in",
        "// deepwmh_tpu_torch/ops/kernels.py by median27_header(); do not edit by",
        "// hand (tests/test_torch_port_analysis.py checks that the two agree).",
        "#pragma once",
        "",
        "// compare-exchange: the min stays on a, the max goes to b",
        "__device__ __forceinline__ void m27_ce(float& a, float& b) {",
        "  const float lo = fminf(a, b);",
        "  b = fmaxf(a, b);",
        "  a = lo;",
        "}",
        "",
        "// sorts one 3-value column in place",
        "__device__ __forceinline__ void m27_column(float (&w)[3]) {",
        *_c_ces(MEDIAN27_COLUMN, "w"),
        "}",
        "",
        "// w: three sorted columns (dx = 0, 1, 2); s: the slab's 9 values sorted",
        "__device__ __forceinline__ void m27_slab(float (&w)[9], float (&s)[9]) {",
        *_c_ces(MEDIAN27_SLAB, "w"),
        *["  s[%d] = w[%d];" % (r, i) for r, i in enumerate(MEDIAN27_SLAB_ORDER)],
        "}",
        "",
        "// w: two sorted slabs; p[r] = rank %d + r of their 18 values"
        % MEDIAN27_PAIR_RANKS[0],
        "__device__ __forceinline__ void m27_pair(float (&w)[18], float (&p)[%d]) {"
        % len(pair),
        *_c_ces(MEDIAN27_PAIR, "w"),
        *["  p[%d] = w[%d];" % (r, i) for r, i in enumerate(pair)],
        "}",
        "",
        "// rank 13 of the pair's 18 values and a third sorted slab's 9",
        "__device__ __forceinline__ float m27_select(const float (&p)[%d], const float (&s)[9]) {"
        % len(pair),
        "  float m = p[%d];" % (MEDIAN27_SELECT_FLOOR - MEDIAN27_PAIR_RANKS[0]),
        *["  m = fmaxf(m, fminf(p[%d], s[%d]));" % (i - MEDIAN27_PAIR_RANKS[0], j)
          for i, j in MEDIAN27_SELECT_TERMS],
        "  return m;",
        "}",
        "",
    ]
    return "\n".join(lines)


class Median3(CudaKernel):
    """K2 (replaces deepwmh_tpu/ops/pallas_kernels.py median3_pallas).
    ``vol`` [D, H, W] f32 -> a new [D, H, W] f32 tensor, zeros outside the
    volume; a batch [B, D, H, W] (what ``vmap`` of the Pallas kernel
    computes) in one launch, each volume with its own zero boundary. On CUDA
    ``vol`` must be contiguous; the kernel is defined on finite input."""

    source = "median3.cu"

    def _bind(self, lib) -> None:
        lib.median3_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.median3_f32.restype = ctypes.c_int

    def __call__(self, vol: torch.Tensor) -> torch.Tensor:
        if vol.dim() not in (3, 4) or vol.dtype != torch.float32 or min(vol.shape) < 1:
            raise ValueError("median3: need an f32 [D, H, W] or [B, D, H, W] tensor with "
                             "every axis >= 1 (got %s %s)" % (vol.dtype, tuple(vol.shape)))
        if vol.device.type == "cpu":
            return median3_reference(vol)
        if vol.device.type != "cuda":
            raise ValueError("median3: unsupported device %s" % vol.device)
        if not vol.is_contiguous():
            raise ValueError("median3: need a contiguous volume (strides %s)"
                             % (vol.stride(),))
        lib = self.lib()
        out = torch.empty_like(vol)
        B = vol.shape[0] if vol.dim() == 4 else 1
        D, H, W = vol.shape[-3:]
        err = _on_device(vol.device, lib.median3_f32, vol.data_ptr(), out.data_ptr(), B, D,
                         H, W, _current_stream(vol.device))
        if err:
            raise RuntimeError("median3: launch failed, CUDA error %d" % err)
        self._count()
        return out


median3 = Median3()

# every kernel of the port, for the build step and the launch counts
KERNELS = {"instance_norm_stats": instance_norm_stats,
           "instance_norm_act": instance_norm_act,
           "instance_norm_act_bwd_stats": instance_norm_act_bwd_stats,
           "instance_norm_act_bwd_dx": instance_norm_act_bwd_dx, "median3": median3}
