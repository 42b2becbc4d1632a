"""Self-contained NIfTI-1 reader/writer (no nibabel dependency).

The port's own copy of ``deepwmh_tpu.core.nifti`` (the port imports nothing
of the JAX package): single-file ``.nii`` / ``.nii.gz`` volumes,
scl_slope/scl_inter scaling, qform/sform affines, RAS+ reorientation,
pixdim extraction and nearest/linear resampling, all on the host in numpy.
``.nii.gz`` reads and writes go through zlib in the port's native host
library (``native.gzip_inflate_host`` / ``gzip_deflate_host``, the JAX
package's ``cc3d.cpp``): the same volume always writes the same bytes, the
JAX package's bytes. Inside ``native.python_path()`` Python's ``gzip``
(``mtime=0``) does the same work, the plain version. A read is the span
``nifti.read`` and a write ``nifti.write`` (``utils/profiling.span``).

Only the NIfTI-1 single-file format is supported (magic ``n+1``), which is
what every tool in the WMH pipeline consumes and produces.
"""

from __future__ import annotations

import gzip
import os
import shutil
import struct
from dataclasses import dataclass, field

import numpy as np

from deepwmh_tpu_torch import native
from deepwmh_tpu_torch.utils.profiling import span

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


@dataclass
class NiftiHeader:
    """Parsed NIfTI-1 header. Carries everything needed to round-trip a file."""

    dim: tuple = (3, 1, 1, 1, 1, 1, 1, 1)
    pixdim: tuple = (1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    datatype: int = 16
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    qform_code: int = 0
    sform_code: int = 1
    quatern: tuple = (0.0, 0.0, 0.0)
    qoffset: tuple = (0.0, 0.0, 0.0)
    srow: np.ndarray = field(
        default_factory=lambda: np.array(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], dtype=np.float64
        )
    )
    descrip: bytes = b""
    xyzt_units: int = 10  # NIFTI_UNITS_MM | NIFTI_UNITS_SEC
    cal_max: float = 0.0
    cal_min: float = 0.0
    endian: str = "<"

    # ------------------------------------------------------------------ #

    def copy(self) -> "NiftiHeader":
        return NiftiHeader(
            dim=tuple(self.dim),
            pixdim=tuple(self.pixdim),
            datatype=self.datatype,
            scl_slope=self.scl_slope,
            scl_inter=self.scl_inter,
            qform_code=self.qform_code,
            sform_code=self.sform_code,
            quatern=tuple(self.quatern),
            qoffset=tuple(self.qoffset),
            srow=np.array(self.srow, copy=True),
            descrip=self.descrip,
            xyzt_units=self.xyzt_units,
            cal_max=self.cal_max,
            cal_min=self.cal_min,
            endian=self.endian,
        )

    @property
    def shape(self) -> tuple:
        ndim = int(self.dim[0])
        return tuple(int(d) for d in self.dim[1 : 1 + ndim])

    @property
    def zooms(self) -> tuple:
        ndim = int(self.dim[0])
        return tuple(float(p) for p in self.pixdim[1 : 1 + ndim])

    @property
    def affine(self) -> np.ndarray:
        """4x4 voxel->world affine. Prefers sform, then qform, then pixdim."""
        if self.sform_code > 0:
            aff = np.eye(4)
            aff[:3, :] = self.srow
            return aff
        if self.qform_code > 0:
            return self._qform_affine()
        aff = np.diag([self.pixdim[1], self.pixdim[2], self.pixdim[3], 1.0])
        return aff

    def _qform_affine(self) -> np.ndarray:
        b, c, d = self.quatern
        a2 = 1.0 - (b * b + c * c + d * d)
        a = np.sqrt(max(a2, 0.0))
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        qfac = -1.0 if self.pixdim[0] < 0 else 1.0
        Z = np.diag([self.pixdim[1], self.pixdim[2], qfac * self.pixdim[3]])
        aff = np.eye(4)
        aff[:3, :3] = R @ Z
        aff[:3, 3] = self.qoffset
        return aff

    def set_shape(self, shape) -> None:
        dim = [len(shape)] + [int(s) for s in shape] + [1] * (7 - len(shape))
        self.dim = tuple(dim)

    def set_zooms(self, zooms) -> None:
        pd = list(self.pixdim)
        for i, z in enumerate(zooms):
            pd[i + 1] = float(z)
        self.pixdim = tuple(pd)


# ---------------------------------------------------------------------- #
# parsing / serialization
# ---------------------------------------------------------------------- #


def _open_maybe_gz(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _parse_header(raw: bytes) -> tuple:
    """Returns (NiftiHeader, vox_offset)."""
    if len(raw) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    endian = "<"
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"
    e = endian
    dim = struct.unpack_from(e + "8h", raw, 40)
    datatype, _bitpix = struct.unpack_from(e + "2h", raw, 70)
    pixdim = struct.unpack_from(e + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(e + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(e + "2f", raw, 112)
    cal_max, cal_min = struct.unpack_from(e + "2f", raw, 124)
    descrip = raw[148:228].split(b"\x00")[0]
    (xyzt_units,) = struct.unpack_from(e + "b", raw, 123)
    qform_code, sform_code = struct.unpack_from(e + "2h", raw, 252)
    qb, qc, qd, qx, qy, qz = struct.unpack_from(e + "6f", raw, 256)
    srow = np.array(
        [
            struct.unpack_from(e + "4f", raw, 280),
            struct.unpack_from(e + "4f", raw, 296),
            struct.unpack_from(e + "4f", raw, 312),
        ],
        dtype=np.float64,
    )
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError("not a NIfTI-1 file (bad magic %r)" % magic)
    hdr = NiftiHeader(
        dim=dim,
        pixdim=pixdim,
        datatype=int(datatype),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        quatern=(qb, qc, qd),
        qoffset=(qx, qy, qz),
        srow=srow,
        descrip=descrip,
        xyzt_units=int(xyzt_units),
        cal_max=float(cal_max),
        cal_min=float(cal_min),
        endian=endian,
    )
    return hdr, int(vox_offset) if vox_offset else _HDR_SIZE + 4


def _serialize_header(hdr: NiftiHeader, datatype: int) -> bytes:
    raw = bytearray(_HDR_SIZE)
    e = "<"
    struct.pack_into(e + "i", raw, 0, _HDR_SIZE)
    raw[38] = ord("r")  # 'regular' flag at byte 38; byte 39 (dim_info) stays 0
    struct.pack_into(e + "8h", raw, 40, *[int(d) for d in hdr.dim])
    np_dtype = np.dtype(_DTYPES[datatype])
    struct.pack_into(e + "2h", raw, 70, datatype, np_dtype.itemsize * 8)
    struct.pack_into(e + "8f", raw, 76, *[float(p) for p in hdr.pixdim])
    struct.pack_into(e + "f", raw, 108, 352.0)  # vox_offset
    struct.pack_into(e + "2f", raw, 112, hdr.scl_slope, hdr.scl_inter)
    struct.pack_into(e + "b", raw, 123, hdr.xyzt_units)
    struct.pack_into(e + "2f", raw, 124, hdr.cal_max, hdr.cal_min)
    descrip = (hdr.descrip or b"deepwmh_tpu")[:79]
    raw[148 : 148 + len(descrip)] = descrip
    struct.pack_into(e + "2h", raw, 252, hdr.qform_code, hdr.sform_code)
    struct.pack_into(e + "6f", raw, 256, *hdr.quatern, *hdr.qoffset)
    struct.pack_into(e + "4f", raw, 280, *hdr.srow[0])
    struct.pack_into(e + "4f", raw, 296, *hdr.srow[1])
    struct.pack_into(e + "4f", raw, 312, *hdr.srow[2])
    raw[344:348] = b"n+1\x00"
    return bytes(raw)


# ---------------------------------------------------------------------- #
# public API (mirrors reference data_io.py surface)
# ---------------------------------------------------------------------- #


def _read_raw(path: str) -> bytes:
    """Read a possibly-gzipped file: zlib through the native library, whose
    first buffer is the gzip trailer's size; Python's ``gzip`` only inside
    ``native.python_path()``."""
    with open(path, "rb") as f:
        blob = f.read()
    if not str(path).endswith(".gz"):
        return blob
    out = native.gzip_inflate_host(blob)
    if out is None:
        native.count("gzip_inflate", python=True)
        out = gzip.decompress(blob)
    return out


@span("nifti.read")
def load_nifti(path, return_type="float32", force_RAS=False, nan=None):
    """Load a NIfTI volume. Returns (data, header).

    Matches the reference contract (deepwmh/utilities/data_io.py:223-263):
    scl_slope/inter applied (like nibabel get_fdata), optional NaN
    replacement, optional RAS+ flip, dtype cast, in that order. With
    ``force_RAS`` the array may be a view with negative strides: pass it
    through ``np.ascontiguousarray`` before ``torch.from_numpy``.
    """
    raw = _read_raw(path)
    hdr, vox_offset = _parse_header(raw)
    np_dtype = np.dtype(_DTYPES[hdr.datatype]).newbyteorder(hdr.endian)
    shape = hdr.shape
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")
    slope, inter = hdr.scl_slope, hdr.scl_inter
    # NIfTI-1 spec (and nibabel get_fdata, which the reference uses): slope 0
    # (or non-finite) means "no scaling" — BOTH slope and inter are ignored;
    # applying only the intercept would shift intensities vs the reference
    if (
        np.isfinite(slope) and np.isfinite(inter)
        and slope != 0.0 and (slope != 1.0 or inter != 0.0)
    ):
        data = data.astype(np.float64) * slope + inter
    if nan is not None:
        data = np.nan_to_num(data, nan=nan)
    if force_RAS:
        data = ras_fix(np.asarray(data), hdr.affine)
    if return_type is not None:
        data = np.asarray(data, dtype=return_type)
    else:
        data = np.asarray(data)
    return data, hdr


def load_nifti_simple(path, return_type="float32"):
    data, _ = load_nifti(path, return_type=return_type)
    return data


def _write_payload(payload, path, level=4):
    """Write atomically (tmp + os.replace): a reader — including a
    concurrent duplicate run after stale-claim recovery, or any consumer
    that trusts a success receipt — must never observe a torn file. A
    loadability probe that accepted a truncated artifact would poison every
    later resume."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if str(path).endswith(".gz"):
        # zlib with mtime 0 on either path: identical data -> identical
        # bytes, so content hashes and re-written duplicate artifacts are
        # deterministic
        blob = native.gzip_deflate_host(payload, level=level)
        if blob is None:
            native.count("gzip_deflate", python=True)
            blob = gzip.compress(payload, compresslevel=level, mtime=0)
    else:
        blob = payload
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


@span("nifti.write")
def save_nifti(data, header, path, dtype="float32", level=4):
    """Save data with an existing header (geometry preserved), as float32.

    Mirrors reference save_nifti (data_io.py:285-286), which always casts to
    float32 and reuses the donor header. `level` is the gzip effort — bulk
    intermediates can pass a lower level (float32 mantissa noise is the
    slow path of DEFLATE for little compression gain).
    """
    data = np.asarray(data, dtype=dtype)
    hdr = header.copy() if isinstance(header, NiftiHeader) else NiftiHeader()
    hdr.set_shape(data.shape)
    hdr.scl_slope, hdr.scl_inter = 1.0, 0.0
    code = _DTYPE_CODES[np.dtype(dtype)]
    hdr.datatype = code
    payload = _serialize_header(hdr, code) + b"\x00" * 4 + data.tobytes(order="F")
    _write_payload(payload, path, level=level)


@span("nifti.write")
def save_nifti_scaled_int16(data, header, path, level=2):
    """Save as int16 with a scl_slope chosen from the data range (standard
    NIfTI intensity scaling: ``load_nifti`` recovers the values to about
    |max|/32000). Registration writes its displacement fields this way:
    half the bytes of float32, and several times faster to deflate.
    Non-finite data raises: one NaN would poison the slope of the whole
    artifact."""
    data = np.asarray(data, dtype=np.float32)
    amax = float(np.max(np.abs(data))) if data.size else 0.0
    if not np.isfinite(amax):
        raise ValueError("save_nifti_scaled_int16(%s): data contains non-finite values" % path)
    slope = max(amax / 32000.0, 1e-9)
    q = np.clip(np.round(data / slope), -32767, 32767).astype(np.int16)
    hdr = header.copy() if isinstance(header, NiftiHeader) else NiftiHeader()
    hdr.set_shape(q.shape)
    hdr.scl_slope, hdr.scl_inter = float(slope), 0.0
    hdr.datatype = _DTYPE_CODES[np.dtype(np.int16)]
    payload = _serialize_header(hdr, hdr.datatype) + b"\x00" * 4 + q.tobytes(order="F")
    _write_payload(payload, path, level=level)


def save_nifti_simple(data, path):
    """Save with a default identity-affine 1mm-isotropic header
    (reference data_io.py:293-296)."""
    save_nifti(data, NiftiHeader(), path)


@span("nifti.write")
def copy_nifti(src, dst, level=4) -> None:
    """Copy a NIfTI file, compressing or decompressing the bytes when the
    two names differ in their ``.gz`` suffix, so the copy reads back."""
    if str(src).endswith(".gz") == str(dst).endswith(".gz"):
        shutil.copyfile(src, dst)
    else:
        _write_payload(_read_raw(src), dst, level=level)


def get_nifti_header(path) -> NiftiHeader:
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read(_HDR_SIZE + 4)
    hdr, _ = _parse_header(raw)
    return hdr


def get_nifti_pixdim(path) -> list:
    """Physical voxel size of the first 3 axes in mm
    (reference data_io.py:311-319)."""
    hdr = get_nifti_header(path)
    zooms = hdr.zooms
    return [float(abs(z)) for z in zooms[:3]]


def try_load_nifti(path) -> bool:
    """Loadability probe used for idempotent resume
    (reference data_io.py:265-283)."""
    try:
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            return False
        load_nifti(path)
        return True
    except Exception:
        return False


def ras_fix(data: np.ndarray, affine: np.ndarray) -> np.ndarray:
    """Flip axes so data is in RAS+ orientation
    (reference data_io.py:208-221)."""
    codes = aff2axcodes(affine)
    for axis, (code, want) in enumerate(zip(codes, "RAS")):
        if code != want:
            data = np.flip(data, axis=axis)
    return data


def aff2axcodes(affine: np.ndarray) -> tuple:
    """Axis direction codes of an affine, e.g. ('R','A','S'): each column
    takes the largest-magnitude row not yet taken (``argsort``'s order
    breaks ties)."""
    R = np.asarray(affine)[:3, :3]
    codes = []
    used = set()
    labels = (("L", "R"), ("P", "A"), ("I", "S"))
    for col in range(3):
        v = R[:, col]
        order = np.argsort(-np.abs(v))
        row = next(int(r) for r in order if int(r) not in used)
        used.add(row)
        neg, pos = labels[row]
        codes.append(pos if v[row] >= 0 else neg)
    return tuple(codes)


def resample_nifti(source_path, new_resolution, output_path, order=0):
    """Resample a NIfTI file to a new physical resolution
    (reference data_io.py:321-340).

    order=0 nearest, order=1 trilinear.
    """
    data, hdr = load_nifti(source_path)
    old = np.array(get_nifti_pixdim(source_path), dtype=np.float64)
    new = np.array(new_resolution, dtype=np.float64)
    scale = old / new
    new_shape = tuple(int(np.round(s * z)) for s, z in zip(data.shape[:3], scale))
    out = _resample_volume(data, new_shape, order=order)
    out_hdr = hdr.copy()
    out_hdr.set_shape(new_shape)
    out_hdr.set_zooms(list(new) + list(hdr.zooms[3:]))
    # each sform column rescaled to the new voxel size: its unit direction
    # (the column over its own norm, not pixdim, so a stale pixdim cannot
    # corrupt the geometry) times the new zoom
    if out_hdr.sform_code > 0:
        srow = np.array(out_hdr.srow)
        for i in range(3):
            norm = np.linalg.norm(srow[:3, i])
            if norm > 0:
                srow[:3, i] *= new[i] / norm
        out_hdr.srow = srow
    save_nifti(out, out_hdr, output_path)


def _resample_volume(data: np.ndarray, new_shape, order=1) -> np.ndarray:
    """Separable numpy resampling (nearest / linear), endpoint-aligned:
    positions in f64, linear weights in f32."""
    out = np.asarray(data, dtype=np.float32)
    for axis, n_new in enumerate(new_shape):
        n_old = out.shape[axis]
        if n_new == n_old:
            continue
        if n_new == 1 or n_old == 1:
            idx = np.zeros(n_new, dtype=np.int64)
            out = np.take(out, idx, axis=axis)
            continue
        x = np.arange(n_new) * (n_old - 1) / (n_new - 1)
        if order == 0:
            idx = np.round(x).astype(np.int64)
            out = np.take(out, idx, axis=axis)
        else:
            lo = np.floor(x).astype(np.int64)
            hi = np.minimum(lo + 1, n_old - 1)
            w = (x - lo).astype(np.float32)
            shape = [1] * out.ndim
            shape[axis] = n_new
            w = w.reshape(shape)
            out = np.take(out, lo, axis=axis) * (1 - w) + np.take(out, hi, axis=axis) * w
    return out


def nifti_main_axis(pixdim) -> str:
    """'sagittal' / 'coronal' / 'axial' from thickest direction
    (reference data_io.py:342-351)."""
    assert len(pixdim) == 3
    return ["sagittal", "coronal", "axial"][int(np.argmax(pixdim))]
