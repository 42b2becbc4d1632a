"""The port's hand-written CUDA kernels, their plain PyTorch versions and
their build.

Each kernel lives in ``deepwmh_tpu_torch/csrc/<name>.cu`` with a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into its
own shared library under ``deepwmh_tpu_torch/_build/`` (named by a hash of
the source and flags, so an edited source rebuilds) and loaded with
``ctypes``. Nothing is built or loaded at import time.

A wrapper takes its kernel's plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises. Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

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
    """Where ``csrc/<source>`` builds to: keyed by the source and flags."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (stem, digest.hexdigest()[:16]))


def build(sources) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns {source: library path}; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``. Raises if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for source in sources:
        out = library_path(source)
        if os.path.isfile(out):
            continue
        tmp = "%s.tmp-%d" % (out, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, proc, tmp, out))
    failed = []
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

    def _bind(self, lib) -> None:
        raise NotImplementedError

    def lib(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build([self.source])[self.source])
                self._bind(lib)
                self._lib = lib
        return self._lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


class InstanceNormStats(CudaKernel):
    """K1 (replaces deepwmh_tpu/ops/pallas_kernels.py
    instance_norm_stats_pallas). ``x`` [N, *spatial, C] bf16 or f32 ->
    (mean, var) f32 [N, C], var unclamped. On CUDA ``x`` must be contiguous
    (a channels-last activation's permuted view is), 16-byte aligned, with
    C a multiple of 16 bytes' worth of elements."""

    source = "instance_norm_stats.cu"
    BLOCKS_PER_SM = 8
    MIN_ROWS_PER_THREAD = 8
    MAX_SHARED = 48 * 1024

    def _bind(self, lib) -> None:
        for fn in (lib.inorm_stats_bf16, lib.inorm_stats_f32):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int

    def __call__(self, x: torch.Tensor):
        if x.device.type == "cpu":
            return instance_norm_stats_reference(x)
        if x.device.type != "cuda":
            raise ValueError("instance_norm_stats: unsupported device %s" % x.device)
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("instance_norm_stats: dtype %s not supported" % x.dtype)
        if x.dim() < 3 or not x.is_contiguous():
            raise ValueError(
                "instance_norm_stats: need a contiguous [N, *spatial, C] view "
                "(shape %s, strides %s)" % (tuple(x.shape), x.stride()))
        N, C = int(x.shape[0]), int(x.shape[-1])
        M = x.numel() // max(N * C, 1)
        vec = 16 // x.element_size()
        groups = C // vec
        if N == 0 or M == 0 or C % vec or x.data_ptr() % 16:
            raise ValueError(
                "instance_norm_stats: need N, M > 0, C %% %d == 0 and a 16-byte "
                "aligned pointer (N=%d M=%d C=%d)" % (vec, N, M, C))
        rows = max(1, 256 // groups)
        if rows * groups > 1024 or 2 * rows * C * 4 > self.MAX_SHARED:
            raise ValueError("instance_norm_stats: C=%d too wide" % C)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        G = max(1, min(-(-M // (rows * self.MIN_ROWS_PER_THREAD)),
                       sms * self.BLOCKS_PER_SM // N))
        partial = torch.empty((N, G, 2, C), dtype=torch.float32, device=x.device)
        mean = torch.empty((N, C), dtype=torch.float32, device=x.device)
        var = torch.empty((N, C), dtype=torch.float32, device=x.device)
        lib = self.lib()
        fn = lib.inorm_stats_bf16 if x.dtype == torch.bfloat16 else lib.inorm_stats_f32
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                     var.data_ptr(), N, M, C, rows, G, 1.0 / M, _stream(x))
        if err:
            raise RuntimeError("instance_norm_stats: launch failed, CUDA error %d" % err)
        self.launches += 1
        return mean, var


instance_norm_stats = InstanceNormStats()


# ---------------------------------------------------------------------- #
# K2: 3x3x3 median
# ---------------------------------------------------------------------- #


def median3_reference(vol: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the 3x3x3 median of ``vol`` [D, H, W] with
    zeros outside, in f32: the 27 shifted views of the zero-padded volume
    stacked on a leading axis, sorted, rank 13."""
    D, H, W = vol.shape
    padded = F.pad(vol.float(), (1, 1, 1, 1, 1, 1))
    win = torch.stack([padded[dz:dz + D, dy:dy + H, dx:dx + W]
                       for dz in range(3) for dy in range(3) for dx in range(3)])
    return torch.sort(win, dim=0).values[13]


def median27_minmax_ops() -> int:
    """min/max instructions per voxel of the kernel's selection network:
    _median27's 27-pass odd-even transposition network with the
    compare-exchanges whose outputs never reach rank 13 removed, as the
    compiler removes them (a live exchange costs one instruction per output
    still needed)."""
    n, needed, ops = 27, {13}, 0
    exchanges = [i for p in range(n) for i in range(p % 2, n - 1, 2)]
    for i in reversed(exchanges):
        live = len({i, i + 1} & needed)
        if live:
            ops += live
            needed |= {i, i + 1}
    return ops


class Median3(CudaKernel):
    """K2 (replaces deepwmh_tpu/ops/pallas_kernels.py median3_pallas).
    ``vol`` [D, H, W] f32 -> a new [D, H, W] f32 tensor, zeros outside the
    volume. On CUDA ``vol`` must be contiguous; the kernel is defined on
    finite input."""

    source = "median3.cu"

    def _bind(self, lib) -> None:
        lib.median3_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.median3_f32.restype = ctypes.c_int

    def __call__(self, vol: torch.Tensor) -> torch.Tensor:
        if vol.dim() != 3 or vol.dtype != torch.float32 or min(vol.shape) < 1:
            raise ValueError("median3: need an f32 [D, H, W] tensor with every axis "
                             ">= 1 (got %s %s)" % (vol.dtype, tuple(vol.shape)))
        if vol.device.type == "cpu":
            return median3_reference(vol)
        if vol.device.type != "cuda":
            raise ValueError("median3: unsupported device %s" % vol.device)
        if not vol.is_contiguous():
            raise ValueError("median3: need a contiguous volume (strides %s)"
                             % (vol.stride(),))
        lib = self.lib()
        out = torch.empty_like(vol)
        D, H, W = vol.shape
        with torch.cuda.device(vol.device):
            err = lib.median3_f32(vol.data_ptr(), out.data_ptr(), D, H, W, _stream(vol))
        if err:
            raise RuntimeError("median3: launch failed, CUDA error %d" % err)
        self.launches += 1
        return out


median3 = Median3()

# every kernel of the port, for the build step and the launch counts
KERNELS = {"instance_norm_stats": instance_norm_stats, "median3": median3}
