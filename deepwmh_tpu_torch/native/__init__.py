"""The host C++ hot loops (the DICOM import's decoders, the NIfTI codec's
gzip) and their ``ctypes`` loader.

``jpegl.cpp`` (the lossless-JPEG Huffman pass and predictor reconstruction),
``jls.cpp`` (the JPEG-LS scan decoder), ``j2k_t1.cpp`` (the JPEG 2000
Tier-1 code-block decoder) and ``cc3d.cpp`` (zlib's gzip inflate and
deflate for ``core/nifti.py``; its component labelling is not wired in, as
labelling runs on the card in ``ops/components``) build together with
``g++ -O3 -fPIC -shared -std=c++17 ... -lz`` at first use into one shared
library under ``deepwmh_tpu_torch/_build/``, named by a hash of the
sources, the compiler and the flags. Nothing is built or loaded at import
time.

A missing compiler or a failed build raises with the compiler's output: the
import and the NIfTI codec never route quietly to Python. A decoder wrapper
returns ``None`` only when the library declines a stream (an error code);
the calling codec's Python decoder then decides, so a malformed stream gives
the same result on either path. A gzip stream zlib cannot read raises.
Inside ``python_path()`` every wrapper declines, which is how the Python
versions (the codecs' decoders, Python's ``gzip``) are run on purpose.

``CALLS`` counts each function's native calls, ``PYTHON_CALLS`` the calls
that the Python versions took over, by the same names.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("jpegl.cpp", "jls.cpp", "j2k_t1.cpp", "cc3d.cpp")
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-shared", "-std=c++17")
LINK_FLAGS = ("-lz",)  # after the sources, as the JAX package's Makefile links
FUNCTIONS = ("jpegl_decode_diffs", "jpegl_reconstruct", "jls_decode_scan", "j2k_decode_block",
             "gzip_inflate", "gzip_deflate")
CALLS = dict.fromkeys(FUNCTIONS, 0)
PYTHON_CALLS = dict.fromkeys(FUNCTIONS, 0)

_lib = None
# first use happens from thread pools (an import fans files out over IO
# threads): without the lock two threads would build and dlopen at once
_build_lock = threading.Lock()
_local = threading.local()


class NativeLibraryError(RuntimeError):
    """The library cannot be had: no compiler, a failed build or load."""


_count_lock = threading.Lock()


def count(name: str, python: bool = False) -> None:
    """One more call of ``name`` on the native path (or, with ``python``,
    taken over by its Python version); calls from IO threads lose none."""
    with _count_lock:
        (PYTHON_CALLS if python else CALLS)[name] += 1


def reset_counts() -> None:
    for counts in (CALLS, PYTHON_CALLS):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def python_path():
    """Within the block (this thread only) every wrapper declines, so the
    codecs decode in Python: the plain versions the native path is held
    against."""
    before = getattr(_local, "python_only", False)
    _local.python_only = True
    try:
        yield
    finally:
        _local.python_only = before


def _declined() -> bool:
    return getattr(_local, "python_only", False)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeLibraryError("the port's native host library needs a C++ compiler: "
                                 "%r is not on PATH (install g++ or point CXX at one)" % cxx)
    return found


def library_path() -> str:
    """Where the sources build to: keyed by the sources, the compiler and
    the flags."""
    digest = hashlib.sha256(("%s %s %s" % (_compiler(), " ".join(CXX_FLAGS),
                                          " ".join(LINK_FLAGS))).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "libdeepwmh_host-%s.so" % digest.hexdigest()[:16])


def build() -> str:
    """Compile the library if it is missing; returns its path. Raises with
    the compiler's output when the build fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp-%d" % (out, os.getpid())
    cmd = [_compiler(), *CXX_FLAGS, *(os.path.join(_HERE, s) for s in SOURCES), *LINK_FLAGS,
           "-o", tmp]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    if proc.returncode:
        raise NativeLibraryError("building the native library failed (%s):\n%s"
                                 % (" ".join(cmd), proc.stdout))
    os.replace(tmp, out)  # atomic: a concurrent process loads whole files only
    return out


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.jpegl_decode_diffs.restype = i64
    lib.jpegl_decode_diffs.argtypes = [u8p, i64, i32p, i64, i64p]
    lib.jpegl_reconstruct.restype = None
    lib.jpegl_reconstruct.argtypes = [i64p, i64, i64, i32, i64, i64p]
    lib.jls_decode_scan.restype = i32
    lib.jls_decode_scan.argtypes = [u8p, i64, i64, i64, i64] + [i32] * 7 + [i64p]
    lib.j2k_decode_block.restype = i32
    lib.j2k_decode_block.argtypes = [u8p, i64] + [i32] * 6 + [i64p]
    lib.gzip_inflate.restype = i64
    lib.gzip_inflate.argtypes = [u8p, i64, u8p, i64]
    lib.gzip_deflate.restype = i64
    lib.gzip_deflate.argtypes = [u8p, i64, u8p, i64, i32]
    lib.gzip_set_chunk_for_testing.restype = None
    lib.gzip_set_chunk_for_testing.argtypes = [i64]


def get_lib():
    """The loaded library, built at first use. Raises when it cannot be had."""
    global _lib
    if _lib is None:
        with _build_lock:
            if _lib is None:
                path = build()
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    raise NativeLibraryError("loading %s failed: %s" % (path, e)) from e
                _bind(lib)
                _lib = lib
    return _lib


def _u8(data) -> tuple:
    src = np.frombuffer(data, np.uint8)
    return src, src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# ---------------------------------------------------------------------- #
# numpy-facing wrappers
# ---------------------------------------------------------------------- #


def jpegl_decode_diffs_host(data: bytes, lut: np.ndarray, n: int):
    """Lossless-JPEG Huffman pass: ``n`` prediction differences from
    unstuffed entropy bytes with a 16-bit-peek LUT (int32[65536], symbol<<5
    | length). Returns int64[n], or None when the stream is declined."""
    if _declined():
        return None
    lib = get_lib()
    src, ptr = _u8(data)
    lut = np.ascontiguousarray(lut, np.int32)
    out = np.empty(int(n), np.int64)
    count("jpegl_decode_diffs")
    got = lib.jpegl_decode_diffs(ptr, len(src), lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 int(n), _i64(out))
    return out if got == n else None


def jpegl_reconstruct_host(diffs: np.ndarray, h: int, w: int, psv: int, default_pred: int):
    """Sequential predictor reconstruction (T.81 H.1.2.1, no restarts).
    Returns int64[h, w], or None inside ``python_path()``."""
    if _declined():
        return None
    lib = get_lib()
    d = np.ascontiguousarray(diffs, np.int64).reshape(-1)
    out = np.empty(int(h) * int(w), np.int64)
    count("jpegl_reconstruct")
    lib.jpegl_reconstruct(_i64(d), int(h), int(w), int(psv), int(default_pred), _i64(out))
    return out.reshape(int(h), int(w))


def jls_decode_scan_host(data: bytes, w, h, maxval, near, t1, t2, t3, reset, qbpp, limit):
    """JPEG-LS scan decode (T.87, one component, ILV = 0). Returns
    int64[h, w], or None when the stream is declined (corrupt)."""
    if _declined():
        return None
    lib = get_lib()
    src, ptr = _u8(data)
    out = np.empty(int(h) * int(w), np.int64)
    count("jls_decode_scan")
    rc = lib.jls_decode_scan(ptr, len(src), int(w), int(h), int(maxval), int(near), int(t1),
                             int(t2), int(t3), int(reset), int(qbpp), int(limit), _i64(out))
    return out.reshape(int(h), int(w)) if rc == 0 else None


def j2k_decode_block_host(data: bytes, w, h, orient, n_passes, msb_plane, segsym):
    """EBCOT Tier-1 code-block decode (T.800 Annex D). Returns int64[h, w]
    of signed coefficients, or None when the stream is declined."""
    if _declined():
        return None
    lib = get_lib()
    src, ptr = _u8(data)
    out = np.empty(int(h) * int(w), np.int64)
    count("j2k_decode_block")
    rc = lib.j2k_decode_block(ptr, len(src), int(w), int(h), int(orient), int(n_passes),
                              int(msb_plane), 1 if segsym else 0, _i64(out))
    return out.reshape(int(h), int(w)) if rc == 0 else None


# ---------------------------------------------------------------------- #
# gzip (zlib) for the NIfTI codec
# ---------------------------------------------------------------------- #


class GzipError(OSError):
    """zlib could not read a gzip stream: corrupt or truncated."""


def _out_u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# DEFLATE expands at most 1032:1, so no gzip stream of n bytes inflates to
# more than this many (several members included)
_MAX_RATIO = 1032


def gzip_isize(data) -> int:
    """The gzip trailer's ISIZE: the last member's uncompressed length mod
    2^32 (the whole stream's for a single member under 4 GiB)."""
    return int.from_bytes(bytes(data[-4:]), "little") if len(data) >= 18 else 0


def gzip_inflate_host(data) -> bytes:
    """Inflate a gzip stream (several members read whole, one after the
    other). The first buffer is the trailer's ISIZE, never more than
    DEFLATE's 1032:1 allows; it grows (twice as large, the stream read
    again) only when a multi-member or 4-GiB-plus stream proves it short.
    Returns the bytes, or None inside ``python_path()``; raises
    ``GzipError`` on a corrupt or truncated stream."""
    if _declined():
        return None
    lib = get_lib()
    src, ptr = _u8(data)
    most = _MAX_RATIO * len(src) + 64
    cap = max(min(gzip_isize(src), most), 1)
    count("gzip_inflate")
    while True:
        out = np.empty(cap, np.uint8)  # pages are touched only as zlib writes
        n = lib.gzip_inflate(ptr, len(src), _out_u8(out), cap)
        if n == -2 and cap < most:  # the buffer filled before the stream ended
            cap = min(2 * cap, most)
            continue
        if n < 0:
            raise GzipError("corrupt or truncated gzip stream (%d bytes)" % len(src))
        return out[:n].tobytes()


def gzip_deflate_host(data, level: int = 4):
    """Deflate ``data`` into one gzip member at ``level`` with zlib's
    defaults (mtime 0, no name): the bytes of ``gzip.compress(data,
    compresslevel=level, mtime=0)``, which uses the same zlib. Returns
    ``bytes``, or None inside ``python_path()``."""
    if _declined():
        return None
    lib = get_lib()
    src, ptr = _u8(data)
    n_in = len(src)
    # zlib's deflateBound for a gzip wrapper, with room to spare
    cap = n_in + (n_in >> 12) + (n_in >> 14) + (n_in >> 25) + 64
    out = np.empty(cap, np.uint8)
    count("gzip_deflate")
    n = lib.gzip_deflate(ptr, n_in, _out_u8(out), cap, int(level))
    if n < 0:
        raise GzipError("zlib deflate failed (level %d, %d bytes)" % (level, n_in))
    return out[:n].tobytes()


def gzip_set_chunk_for_testing(chunk: int) -> None:
    """Feed zlib ``chunk`` bytes at a time (0: the default 1 GiB), so small
    streams exercise the refill loops."""
    get_lib().gzip_set_chunk_for_testing(int(chunk))
