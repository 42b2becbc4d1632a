"""Self-contained NIfTI-1 reader/writer (no nibabel dependency).

The port's own copy of ``deepwmh_tpu.core.nifti`` (the port imports nothing
of the JAX package): single-file ``.nii`` / ``.nii.gz`` volumes,
scl_slope/scl_inter scaling, qform/sform affines and pixdim extraction. Compression is Python's ``gzip`` with ``mtime=0``, so the
same volume always writes the same bytes.

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
    """Read a possibly-gzipped file."""
    with _open_maybe_gz(path, "rb") as f:
        return f.read()


def load_nifti(path, return_type="float32"):
    """Load a NIfTI volume. Returns (data, header).

    Matches the reference contract (deepwmh/utilities/data_io.py:223-263):
    scl_slope/inter applied (like nibabel get_fdata), dtype cast.
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
        # mtime=0: identical data -> identical bytes, so content hashes and
        # re-written duplicate artifacts are deterministic
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

