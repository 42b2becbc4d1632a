"""The benchmark's own NIfTI-1 reading and writing (numpy and ``gzip``):
it writes the inputs it hands the program and reads back what the program
wrote, without the program's I/O code."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64}
_HDR = 348


def write_nifti(path: str, data: np.ndarray, spacing, level: int = 1, dtype=np.float32,
                sync: bool = False) -> None:
    """A volume [D, H, W] as ``dtype`` (float32, or uint8 for a label map
    that holds small whole numbers) with an sform of the voxel sizes;
    ``sync`` waits until the file is on disk."""
    data = np.asarray(data, dtype)
    code = {np.dtype(v): k for k, v in _DTYPES.items()}[data.dtype]
    hdr = bytearray(_HDR)
    struct.pack_into("<i", hdr, 0, _HDR)
    hdr[38] = ord("r")
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, code, 8 * data.itemsize)
    struct.pack_into("<8f", hdr, 76, 1.0, *[float(s) for s in spacing], 0.0, 0.0, 0.0, 0.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<b", hdr, 123, 10)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    for row in range(3):
        srow = [0.0, 0.0, 0.0, 0.0]
        srow[row] = float(spacing[row])
        struct.pack_into("<4f", hdr, 280 + 16 * row, *srow)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with open(path, "wb") as f:
        f.write(gzip.compress(payload, compresslevel=level, mtime=0)
                if path.endswith(".gz") else payload)
        if sync:
            f.flush()
            os.fsync(f.fileno())


def read_nifti(path: str) -> np.ndarray:
    """The volume of a little-endian NIfTI-1 file as float32 [D, H, W]."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".gz"):
        raw = gzip.decompress(raw)
    if struct.unpack_from("<i", raw, 0)[0] != _HDR:
        raise ValueError("%s: not a little-endian NIfTI-1 file" % path)
    dim = struct.unpack_from("<8h", raw, 40)
    shape = tuple(int(d) for d in dim[1:1 + dim[0]])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    offset = int(struct.unpack_from("<f", raw, 108)[0]) or _HDR + 4
    slope, inter = struct.unpack_from("<2f", raw, 112)
    data = np.frombuffer(raw, _DTYPES[datatype], count=int(np.prod(shape)), offset=offset)
    data = data.reshape(shape, order="F").astype(np.float32)
    if (np.isfinite(slope) and np.isfinite(inter) and slope != 0.0
            and (slope != 1.0 or inter != 0.0)):
        data = data * np.float32(slope) + np.float32(inter)
    return np.ascontiguousarray(data)
