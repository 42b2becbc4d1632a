"""DICOM writers for the port's import tests and ``chip_smoke.py``.

numpy and the port only (no JAX), so the card's machine can import it. It
writes classic single-frame series in every transfer syntax the import
reads and enhanced multi-frame files, from an array ``vol[rows, cols,
slices]``:

    paths = write_series(folder, vol, syntax, spacing=(1, 1, 1),
                         origin=(0, 0, 0), iop=(1, 0, 0, 0, 1, 0), ...)
    path = write_enhanced(path, vol, syntax, ...)

A JPEG 2000 series takes its streams from the caller (``streams=``): the
port has no JPEG 2000 encoder. ``expected_affine`` states the RAS affine a
series must convert to, from the standard's definition of the patient
coordinates of a pixel (PS3.3 C.7.6.2.1.1), independently of the reader.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

EXPLICIT_LE = "1.2.840.10008.1.2.1"
IMPLICIT_LE = "1.2.840.10008.1.2"
DEFLATED_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_BE = "1.2.840.10008.1.2.2"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"

ENCAPSULATED = {RLE_LOSSLESS, JPEG_BASELINE, JPEG_EXTENDED, JPEG_LOSSLESS_P14,
                JPEG_LOSSLESS_SV1, JPEG_LS_LOSSLESS, JPEG_LS_NEAR, JPEG2000_LOSSLESS, JPEG2000}
_LONG_VRS = {b"OB", b"OD", b"OF", b"OL", b"OV", b"OW", b"SQ", b"SV", b"UC", b"UN", b"UR",
             b"UT", b"UV"}


def _pad(vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in (b"UI", b"OB") else b" "
    return value


def element(group, elem, vr: bytes, value: bytes, endian="<", explicit=True) -> bytes:
    """One data element; the value is padded to even length."""
    value = _pad(vr, value)
    if not explicit:
        return struct.pack(endian + "HHI", group, elem, len(value)) + value
    if vr in _LONG_VRS:
        return struct.pack(endian + "HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack(endian + "HH2sH", group, elem, vr, len(value)) + value


def _ds(values) -> bytes:
    return "\\".join("%.10g" % v for v in values).encode()


def _item(payload: bytes) -> bytes:
    return struct.pack("<HHI", 0xFFFE, 0xE000, len(payload)) + payload


def encapsulate(frames) -> bytes:
    """(7FE0,0010) OB of undefined length: an empty offset table, one
    fragment a frame, the sequence delimiter."""
    out = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF) + _item(b"")
    for stream in frames:
        out += _item(_pad(b"OB", stream))
    return out + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)


def _packbits(data: bytes) -> bytes:
    """PackBits (PS3.5 G.3.1): runs of three or more equal bytes as
    replicate runs, the rest as literal runs of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def rle_frame(pixel: np.ndarray) -> bytes:
    """One RLE Lossless frame: the 64-byte header, then a PackBits segment
    a byte plane, most significant first."""
    flat = np.ascontiguousarray(pixel).reshape(-1)
    if flat.dtype.itemsize == 1:
        planes = [flat.view(np.uint8).tobytes()]
    else:
        u = flat.astype(np.int64) & 0xFFFF
        planes = [(u >> 8).astype(np.uint8).tobytes(), (u & 0xFF).astype(np.uint8).tobytes()]
    segs = [_pad(b"OB", _packbits(p)) for p in planes]
    offsets, at = [], 64
    for s in segs:
        offsets.append(at)
        at += len(s)
    header = struct.pack("<16I", len(segs), *offsets, *([0] * (15 - len(segs))))
    return header + b"".join(segs)


def encode_frame(pixel: np.ndarray, syntax: str, precision: int, predictor=1, near=0,
                 quality=95) -> bytes:
    """The compressed stream of one frame in ``syntax`` with the port's
    encoders."""
    from deepwmh_tpu_torch.core import jlscodec, jpegcodec

    if syntax == RLE_LOSSLESS:
        return rle_frame(pixel)
    if syntax in (JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1):
        return jpegcodec.encode_lossless(pixel, predictor=predictor if syntax == JPEG_LOSSLESS_P14
                                         else 1, precision=precision)
    if syntax in (JPEG_BASELINE, JPEG_EXTENDED):
        return jpegcodec.encode_dct(pixel, quality=quality, precision=precision)
    if syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR):
        return jlscodec.encode(pixel, near=near if syntax == JPEG_LS_NEAR else 0,
                               precision=precision)
    raise ValueError("no encoder for syntax %s (pass streams=)" % syntax)


def expected_affine(spacing, origin, iop) -> np.ndarray:
    """The RAS voxel -> world affine of a series written by ``write_series``
    (voxel (r, c, k): row r, column c of slice k). PS3.3 C.7.6.2.1.1: the
    LPS position of pixel (r, c) is IPP + c * dc * X + r * dr * Y with X
    the row direction cosines, Y the column ones, dc the column spacing
    (PixelSpacing[1]) and dr the row spacing (PixelSpacing[0]); slice k
    sits k * dz along X x Y. RAS negates x and y."""
    x, y = np.asarray(iop[:3], float), np.asarray(iop[3:], float)
    lps = np.eye(4)
    lps[:3, 0] = y * spacing[0]
    lps[:3, 1] = x * spacing[1]
    lps[:3, 2] = np.cross(x, y) * spacing[2]
    lps[:3, 3] = origin
    return np.diag([-1.0, -1.0, 1.0, 1.0]) @ lps


def _geometry(ipp, iop, spacing, instance, series_uid, rows, cols, bits, signed, bits_stored,
              slope, intercept, e, explicit) -> bytes:
    def el(g, m, vr, v):
        return element(g, m, vr, v, e, explicit)

    body = el(0x0008, 0x0018, b"UI", ("%s.%d" % (series_uid, instance)).encode())
    body += el(0x0020, 0x000E, b"UI", series_uid.encode())
    body += el(0x0020, 0x0013, b"IS", str(instance).encode())
    body += el(0x0020, 0x0032, b"DS", _ds(ipp))
    body += el(0x0020, 0x0037, b"DS", _ds(iop))
    body += el(0x0028, 0x0010, b"US", struct.pack(e + "H", rows))
    body += el(0x0028, 0x0011, b"US", struct.pack(e + "H", cols))
    body += el(0x0028, 0x0030, b"DS", _ds(spacing[:2]))
    body += el(0x0018, 0x0050, b"DS", _ds(spacing[2:]))
    body += el(0x0028, 0x0100, b"US", struct.pack(e + "H", bits))
    body += el(0x0028, 0x0101, b"US", struct.pack(e + "H", bits_stored))
    body += el(0x0028, 0x0103, b"US", struct.pack(e + "H", 1 if signed else 0))
    body += el(0x0028, 0x1052, b"DS", _ds([intercept]))
    body += el(0x0028, 0x1053, b"DS", _ds([slope]))
    return body


def _file(path, syntax: str, body: bytes) -> None:
    meta = element(0x0002, 0x0010, b"UI", syntax.encode())
    if syntax == DEFLATED_LE:
        co = zlib.compressobj(wbits=-15)
        body = co.compress(body) + co.flush()
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def write_series(folder, vol: np.ndarray, syntax: str, spacing=(1.0, 1.0, 1.0),
                 origin=(0.0, 0.0, 0.0), iop=(1, 0, 0, 0, 1, 0), series_uid="1.2.826.0.1.7",
                 precision=None, signed=False, slope=1.0, intercept=0.0, predictor=1, near=0,
                 quality=95, streams=None, prefix="slice", slices=None) -> list:
    """One file a slice of ``vol[rows, cols, slices]`` (uint8 / uint16, or
    int16 with ``signed``, stored as ``precision``-bit codes in the
    compressed syntaxes), slice k at ``origin`` + k * spacing[2] along the
    normal, named ``<prefix><k:04d>.dcm``. ``slices`` writes only those
    slice indices (a part of the series, for writers working in parallel).
    Files are written in a shuffled order. Returns the paths."""
    os.makedirs(folder, exist_ok=True)
    rows, cols, n = vol.shape
    bits = 8 if vol.dtype.itemsize == 1 else 16
    precision = precision or bits
    e = ">" if syntax == EXPLICIT_BE else "<"
    explicit = syntax != IMPLICIT_LE
    normal = np.cross(np.asarray(iop[:3], float), np.asarray(iop[3:], float))
    todo = set(range(n) if slices is None else slices)
    paths = []
    for k in np.random.RandomState(n).permutation(n):
        if k not in todo:
            continue
        pixel = vol[:, :, k]
        if syntax in ENCAPSULATED:
            if streams is not None:
                stream = streams[k]
            else:
                codes = pixel.astype(np.int64) & ((1 << precision) - 1) if signed else pixel
                stream = encode_frame(codes.astype(np.uint8 if bits == 8 else np.uint16), syntax,
                                      precision, predictor=predictor, near=near, quality=quality)
            pixel_el = encapsulate([stream])
        else:
            dt = np.dtype(("i" if signed else "u") + str(bits // 8)).newbyteorder(e)
            pixel_el = element(0x7FE0, 0x0010, b"OB" if bits == 8 else b"OW",
                               pixel.astype(dt).tobytes(), e, explicit)
        ipp = np.asarray(origin, float) + k * spacing[2] * normal
        body = _geometry(ipp, iop, spacing, int(k) + 1, series_uid, rows, cols, bits, signed,
                         precision, slope, intercept, e, explicit)
        paths.append(os.path.join(folder, "%s%04d.dcm" % (prefix, k)))
        _file(paths[-1], syntax, body + pixel_el)
    return sorted(paths)


def _sq(group, elem, items: bytes) -> bytes:
    return struct.pack("<HH2sHI", group, elem, b"SQ", 0, len(items)) + items


def write_enhanced(path, vol: np.ndarray, syntax=EXPLICIT_LE, spacing=(1.0, 1.0, 1.0),
                   origin=(0.0, 0.0, 0.0), iop=(1, 0, 0, 0, 1, 0),
                   series_uid="1.2.826.0.1.8") -> str:
    """An enhanced multi-frame file of ``vol[rows, cols, frames]`` (uint16):
    orientation and pixel measures in the shared functional groups, one
    plane position a frame in the per-frame groups, frames in reverse
    order of position; native pixels (explicit VR LE) or one JPEG Lossless
    SV1 fragment a frame."""
    rows, cols, nf = vol.shape
    normal = np.cross(np.asarray(iop[:3], float), np.asarray(iop[3:], float))
    order = list(range(nf))[::-1]
    shared = _sq(0x5200, 0x9229, _item(
        _sq(0x0020, 0x9116, _item(element(0x0020, 0x0037, b"DS", _ds(iop))))
        + _sq(0x0028, 0x9110, _item(element(0x0028, 0x0030, b"DS", _ds(spacing[:2]))
                                    + element(0x0018, 0x0088, b"DS", _ds(spacing[2:]))))))
    perframe = _sq(0x5200, 0x9230, b"".join(
        _item(_sq(0x0020, 0x9113, _item(element(
            0x0020, 0x0032, b"DS", _ds(np.asarray(origin, float) + k * spacing[2] * normal)))))
        for k in order))
    frames = [np.ascontiguousarray(vol[:, :, k]).astype(np.uint16) for k in order]
    if syntax == EXPLICIT_LE:
        pixel_el = element(0x7FE0, 0x0010, b"OW", b"".join(f.astype("<u2").tobytes()
                                                           for f in frames))
    else:
        pixel_el = encapsulate([encode_frame(f, syntax, 16) for f in frames])
    body = element(0x0008, 0x0018, b"UI", (series_uid + ".1").encode())
    body += element(0x0020, 0x000E, b"UI", series_uid.encode())
    body += element(0x0020, 0x0013, b"IS", b"1")
    body += element(0x0028, 0x0008, b"IS", str(nf).encode())
    body += element(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += element(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    body += element(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += element(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    _file(path, syntax, body + shared + perframe + pixel_el)
    return path
