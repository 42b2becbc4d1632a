"""Minimal DICOM series -> NIfTI conversion.

Replaces the dcm2niix adapter (deepwmh/external_tools/dcm2niix.py:5-77) for
the common MRI case: single-frame DICOM series in implicit/explicit VR
little endian, Deflated explicit VR (zlib), RLE Lossless (PS3.5 Annex G
PackBits segments), and the JPEG family decoded by the from-scratch codec
in core/jpegcodec.py — JPEG Baseline (.50), Extended 12-bit (.51),
Lossless Process 14 / SV1 (.57/.70) — plus JPEG-LS (.80/.81) via the T.87
codec in core/jlscodec.py and JPEG 2000 (.90/.91) via the T.800 codec in
core/j2kcodec.py. Slices are grouped by SeriesInstanceUID, sorted along
the slice normal (ImageOrientationPatient x ImagePositionPatient),
stacked, rescaled (RescaleSlope/Intercept) and written as NIfTI with an
LPS->RAS sform affine — every compressed syntax the reference's dcm2niix
handles now decodes in-process, plus the retired Explicit VR Big Endian
syntax and enhanced multi-frame files (per-frame geometry from the
functional-group sequences, native or fragment-per-frame encapsulated).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from deepwmh_tpu_torch import native

EXPLICIT_LE = "1.2.840.10008.1.2.1"
IMPLICIT_LE = "1.2.840.10008.1.2"
DEFLATED_LE = "1.2.840.10008.1.2.1.99"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
EXPLICIT_BE = "1.2.840.10008.1.2.2"  # retired, still seen in old archives

JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"
_JPEG_SYNTAXES = {
    JPEG_BASELINE, JPEG_EXTENDED, JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
}
_JPEG_LS_SYNTAXES = {JPEG_LS_LOSSLESS, JPEG_LS_NEAR}
_J2K_SYNTAXES = {JPEG2000_LOSSLESS, JPEG2000}


# ALL long-form explicit VRs (PS3.5 §7.1.2): 2-byte reserved word then a
# 4-byte length. Missing any of these desyncs the explicit-VR parser (the
# 2-byte length would be read from the reserved word) and silently corrupts
# every subsequent tag.
_LONG_VRS = {
    b"OB", b"OD", b"OF", b"OL", b"OV", b"OW",
    b"SQ", b"SV", b"UC", b"UN", b"UR", b"UT", b"UV",
}

TAGS = {
    (0x0002, 0x0010): "transfer_syntax",
    (0x0008, 0x0018): "sop_uid",
    (0x0020, 0x000E): "series_uid",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "ipp",
    (0x0020, 0x0037): "iop",
    (0x0028, 0x0008): "number_of_frames",
    (0x5200, 0x9229): "shared_fg",    # SharedFunctionalGroupsSequence
    (0x5200, 0x9230): "perframe_fg",  # PerFrameFunctionalGroupsSequence
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixel_data",
}


class DicomError(ValueError):
    pass


def _parse_fragments(buf, offset, endian="<"):
    """Parse an encapsulated pixel-data item sequence (PS3.5 A.4): Basic
    Offset Table item + fragment items, ended by a sequence delimiter.
    Returns (fragments list WITHOUT the offset table, offset past the
    delimiter)."""
    fragments = []
    first = True
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        (length,) = struct.unpack_from(endian + "I", buf, offset + 4)
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return fragments, offset
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(
                "malformed encapsulated pixel data: tag (%04x,%04x)"
                % (group, elem)
            )
        item = buf[offset : offset + length]
        offset += length
        if first:
            first = False  # Basic Offset Table (possibly empty) — drop it
        else:
            fragments.append(item)
    raise DicomError("encapsulated pixel data missing sequence delimiter")


def _skip_dataset_element(buf, offset, endian="<"):
    """End offset of ONE dataset element starting at `offset`, recursing
    into undefined-length sequences. Tolerates explicit or implicit VR
    (sniffed from the two VR bytes)."""
    vr = buf[offset + 4 : offset + 6]
    explicit = vr.isalpha() and vr.isupper()
    if explicit and vr in _LONG_VRS:
        (length,) = struct.unpack_from(endian + "I", buf, offset + 8)
        head = 12
    elif explicit:
        (length,) = struct.unpack_from(endian + "H", buf, offset + 6)
        head = 8
    else:
        (length,) = struct.unpack_from(endian + "I", buf, offset + 4)
        head = 8
    if length == 0xFFFFFFFF:
        return _skip_undefined_sequence(buf, offset + head, endian)
    return offset + head + length


def _skip_undefined_item(buf, offset, endian="<"):
    """Walk the elements of one undefined-length item until its (FFFE,E00D)
    delimiter; returns the offset just past the delimiter."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        if (group, elem) == (0xFFFE, 0xE00D):
            return offset + 8
        offset = _skip_dataset_element(buf, offset, endian)
    raise DicomError("undefined-length item missing delimiter")


def _skip_undefined_sequence(buf, offset, endian="<"):
    """Skip an undefined-length SQ (offset points at its first item tag):
    items may be defined- or undefined-length, elements inside items may
    themselves be (nested) sequences. Returns the offset just past the
    (FFFE,E0DD) sequence delimiter."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        (length,) = struct.unpack_from(endian + "I", buf, offset + 4)
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return offset
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(
                "malformed sequence: tag (%04x,%04x)" % (group, elem)
            )
        if length == 0xFFFFFFFF:
            offset = _skip_undefined_item(buf, offset, endian)
        else:
            offset += length
    raise DicomError("undefined-length sequence missing delimiter")


def _parse_elements(buf, offset, explicit, stop_at_pixels=True, endian="<"):
    """Yield (tag, value) for top-level elements. SQ contents are skipped
    (not needed for volume assembly); encapsulated (undefined-length) pixel
    data yields a LIST of fragment bytes instead of raw bytes."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        offset += 4
        vr = b""
        if explicit:
            vr = buf[offset : offset + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from(endian + "I", buf, offset + 4)
                offset += 8
            else:
                (length,) = struct.unpack_from(endian + "H", buf, offset + 2)
                offset += 4
        else:
            (length,) = struct.unpack_from(endian + "I", buf, offset)
            offset += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == (0x7FE0, 0x0010):
                fragments, offset = _parse_fragments(buf, offset, endian)
                yield (group, elem), fragments
                if stop_at_pixels:
                    return
                continue
            # undefined-length SQ: capture raw bytes for the functional
            # groups (multi-frame geometry lives inside), skip the rest
            end = _skip_undefined_sequence(buf, offset, endian)
            if (group, elem) in ((0x5200, 0x9229), (0x5200, 0x9230)):
                yield (group, elem), buf[offset : end - 8]  # drop delimiter
            offset = end
            continue
        value = buf[offset : offset + length]
        offset += length
        yield (group, elem), value
        if stop_at_pixels and (group, elem) == (0x7FE0, 0x0010):
            return


def read_dicom(path: str) -> dict:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 132 + 8 or buf[128:132] != b"DICM":
        raise DicomError("%s: not a DICOM part-10 file" % path)

    fields = {}
    # file meta group (always explicit VR LE); read until group != 0x0002
    offset = 132
    meta_end = offset
    for tag, value in _parse_elements(buf, offset, explicit=True, stop_at_pixels=False):
        if tag[0] != 0x0002:
            break
        if tag in TAGS:
            fields[TAGS[tag]] = value
        # recompute end position by re-walking (cheap; meta group is tiny)
        meta_end = _element_end(buf, meta_end, explicit=True)

    syntax = fields.get("transfer_syntax", b"").decode("ascii", "ignore").strip("\x00 ")
    fields["transfer_syntax_uid"] = syntax
    endian = "<"
    if syntax == IMPLICIT_LE:
        explicit = False
    elif syntax == EXPLICIT_BE:
        explicit = True
        endian = ">"
    elif (
        syntax in (EXPLICIT_LE, RLE_LOSSLESS, "")
        or syntax in _JPEG_SYNTAXES
        or syntax in _JPEG_LS_SYNTAXES
        or syntax in _J2K_SYNTAXES
    ):
        explicit = True  # encapsulated datasets are explicit VR LE outside PixelData
    elif syntax == DEFLATED_LE:
        # the whole post-meta dataset is one raw zlib-deflate stream
        buf = zlib.decompress(buf[meta_end:], -15)
        meta_end = 0
        explicit = True
    else:
        raise DicomError("%s: unsupported transfer syntax %r" % (path, syntax))

    fields["endian"] = endian
    for tag, value in _parse_elements(buf, meta_end, explicit=explicit, endian=endian):
        if tag in TAGS:
            fields[TAGS[tag]] = value
    return fields


def _iter_sq_items(seq: bytes, endian="<"):
    """Yield the payload bytes of each (FFFE,E000) item in a captured SQ.
    Handles defined- and undefined-length items (the latter end with an
    (FFFE,E00D) item delimiter), with arbitrarily nested sequences."""
    i, n = 0, len(seq)
    while i + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", seq, i)
        (length,) = struct.unpack_from(endian + "I", seq, i + 4)
        i += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError("malformed SQ item tag (%04x,%04x)" % (group, elem))
        if length != 0xFFFFFFFF:
            yield seq[i : i + length]
            i += length
        else:
            end = _skip_undefined_item(seq, i, endian)
            yield seq[i : end - 8]  # drop the item delimiter
            i = end


def _find_tag(item: bytes, want, endian="<", depth=0):
    """Depth-first search for a tag inside functional-group item bytes;
    returns the raw value bytes or None. Descends into nested sequences
    (PlanePositionSequence etc. wrap the classic tags one level down)."""
    if depth > 6:
        return None
    i, n = 0, len(item)
    while i + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", item, i)
        if (group, elem) in ((0xFFFE, 0xE000), (0xFFFE, 0xE00D), (0xFFFE, 0xE0DD)):
            i += 8
            continue
        vr = item[i + 4 : i + 6]
        explicit = vr.isalpha() and vr.isupper()
        if explicit and vr in _LONG_VRS:
            (length,) = struct.unpack_from(endian + "I", item, i + 8)
            head = 12
        elif explicit:
            (length,) = struct.unpack_from(endian + "H", item, i + 6)
            head = 8
        else:
            (length,) = struct.unpack_from(endian + "I", item, i + 4)
            head = 8
        if length == 0xFFFFFFFF:
            # nested undefined-length SQ: bounded by our caller's capture
            body = item[i + head :]
        else:
            body = item[i + head : i + head + length]
        if (group, elem) == want:
            return body
        if (explicit and vr == b"SQ") or (
            not explicit and length == 0xFFFFFFFF
        ):
            found = _find_tag(body, want, endian, depth + 1)
            if found is not None:
                return found
        elif not explicit:
            # implicit VR could still be a defined-length SQ; peek for an
            # item tag at the start
            if len(body) >= 8 and struct.unpack_from(endian + "HH", body, 0) == (0xFFFE, 0xE000):
                found = _find_tag(body, want, endian, depth + 1)
                if found is not None:
                    return found
        if length == 0xFFFFFFFF:
            return None  # cannot hop an undefined-length element reliably
        i += head + length
    return None


def _rle_decode_segment(data: bytes) -> bytes:
    """PackBits decode of one RLE segment (DICOM PS3.5 Annex G.3.1)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:  # copy the next h+1 bytes literally
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:  # repeat the next byte 257-h times
            if i < n:
                out += data[i : i + 1] * (257 - h)
                i += 1
        # h == 128: no-op
    return bytes(out)


def _rle_decode_frame(fragment, rows, cols, bits, signed):
    """One RLE Lossless frame (PS3.5 Annex G): a 64-byte header of up to 15
    little-endian segment offsets, then PackBits segments — one segment per
    byte plane of the composite pixel code, MSB plane first."""
    if len(fragment) < 64:
        raise DicomError("RLE frame shorter than its 64-byte header")
    n_seg = struct.unpack_from("<I", fragment, 0)[0]
    offsets = struct.unpack_from("<15I", fragment, 4)[:n_seg]
    npix = rows * cols
    planes = []
    for k in range(n_seg):
        start = offsets[k]
        end = offsets[k + 1] if k + 1 < n_seg else len(fragment)
        seg = _rle_decode_segment(fragment[start:end])
        if len(seg) < npix:
            raise DicomError(
                "RLE segment %d: %d bytes < %d pixels" % (k, len(seg), npix)
            )
        planes.append(np.frombuffer(seg, np.uint8, count=npix))
    if bits == 8:
        if n_seg != 1:
            raise DicomError("RLE: %d segments for 8-bit pixels" % n_seg)
        pix = planes[0]
        return pix.view(np.int8) if signed else pix
    if bits == 16:
        if n_seg != 2:
            raise DicomError("RLE: %d segments for 16-bit pixels" % n_seg)
        pix = (planes[0].astype(np.uint16) << 8) | planes[1]
        return pix.view(np.int16) if signed else pix
    raise DicomError("RLE: unsupported bits_allocated=%d" % bits)


def _element_end(buf, offset, explicit):
    group, elem = struct.unpack_from("<HH", buf, offset)
    offset += 4
    if explicit:
        vr = buf[offset : offset + 2]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, offset + 4)
            offset += 8
        else:
            (length,) = struct.unpack_from("<H", buf, offset + 2)
            offset += 4
    else:
        (length,) = struct.unpack_from("<I", buf, offset)
        offset += 4
    return offset + length


def _ds(value, default=None):
    try:
        return [float(v) for v in value.decode("ascii", "ignore").strip("\x00 ").split("\\")]
    except Exception:
        return default


def _us(value, default=0, endian="<"):
    return struct.unpack(endian + "H", value[:2])[0] if len(value) >= 2 else default


def _decode_frame_pixels(f, p, rows, cols, bits, signed, dt, en, nf):
    """Decode ALL frames of one file -> [nf, rows, cols] array."""
    syn = f.get("transfer_syntax_uid")
    if isinstance(f["pixel_data"], list):  # encapsulated fragments
        frags = f["pixel_data"]
        if nf > 1 and len(frags) != nf:
            raise DicomError(
                "%s: %d fragments for %d frames (fragment-per-frame is the "
                "only supported encapsulated multi-frame layout)"
                % (p, len(frags), nf)
            )
        if syn == RLE_LOSSLESS and nf == 1 and len(frags) != 1:
            # each RLE frame is exactly one fragment (PS3.5 A.4.2);
            # concatenating would decode garbage silently
            raise DicomError(
                "%s: %d RLE fragments for a single-frame image" % (p, len(frags))
            )
        streams = frags if nf > 1 else [b"".join(frags)]
        out = []
        for k, stream in enumerate(streams):
            if syn == RLE_LOSSLESS:
                pix = _rle_decode_frame(stream, rows, cols, bits, signed)
                pix = pix.reshape(rows, cols)
            elif (
                syn in _JPEG_SYNTAXES
                or syn in _JPEG_LS_SYNTAXES
                or syn in _J2K_SYNTAXES
            ):
                try:
                    if syn in _JPEG_LS_SYNTAXES:
                        from deepwmh_tpu_torch.core import jlscodec

                        pix, prec = jlscodec.decode(stream)
                    elif syn in _J2K_SYNTAXES:
                        from deepwmh_tpu_torch.core import j2kcodec

                        pix, prec = j2kcodec.decode(stream)
                    else:
                        from deepwmh_tpu_torch.core import jpegcodec

                        pix, prec = jpegcodec.decode(stream)
                except ValueError as e:  # JpegError / JlsError / J2kError
                    raise DicomError(
                        "%s: frame %d decode failed: %s" % (p, k, e)
                    )
                if pix.ndim != 2:
                    pix = pix[..., 0]  # MRI is monochrome; drop extra planes
                if pix.shape != (rows, cols):
                    raise DicomError(
                        "%s: frame %d shape %s != Rows/Columns (%d, %d)"
                        % (p, k, pix.shape, rows, cols)
                    )
                if signed:
                    # Sign-extend from the CODESTREAM precision, not the
                    # container width: a 12-bit signed series (common on
                    # Philips/GE; PixelRepresentation=1, BitsStored=12)
                    # stores -1 as 0xFFF — two's complement at the stored
                    # width, which dcm2niix likewise extends from BitsStored.
                    prec = min(int(prec), bits)
                    pix = pix.astype(np.int32)
                    if prec < 32:
                        pix[pix >= (1 << (prec - 1))] -= 1 << prec
                    pix = pix.astype(np.int16 if bits == 16 else np.int8)
            else:
                raise DicomError(
                    "%s: encapsulated pixel data in syntax %r is not "
                    "decodable here" % (p, syn)
                )
            out.append(pix)
        return np.stack(out)
    # native: frames are contiguous in the pixel buffer
    return np.frombuffer(
        f["pixel_data"], dtype=np.dtype(dt).newbyteorder(en),
        count=nf * rows * cols,
    ).reshape(nf, rows, cols)


def series_to_volume(paths, parsed=None):
    """Assemble one series from DICOM file paths — classic single-frame
    series AND enhanced multi-frame files (per-frame geometry from the
    PerFrameFunctionalGroupsSequence). Returns
    (volume [rows, cols, slices] float32, spacing [3] mm, affine 4x4 RAS).

    parsed: optional {path: read_dicom(path) dict} cache so a caller that
    already parsed the files (convert_directory's grouping walk) does not
    pay the parse + pixel-slicing twice."""
    slices = []
    for p in paths:
        f = parsed[p] if parsed is not None and p in parsed else read_dicom(p)
        if "pixel_data" not in f:
            continue
        en = f.get("endian", "<")
        nframes = f.get("number_of_frames")
        nf = 1
        if nframes is not None:
            try:
                nf = int(nframes.decode("ascii", "ignore").strip("\x00 ") or 1)
            except ValueError:
                nf = 1
        rows, cols = _us(f["rows"], endian=en), _us(f["cols"], endian=en)
        bits = _us(f.get("bits_allocated", b"\x10\x00"), endian=en)
        signed = _us(f.get("pixel_representation", b"\x00\x00"), endian=en) == 1
        if bits == 16:
            dt = np.int16 if signed else np.uint16
        elif bits == 8:
            dt = np.int8 if signed else np.uint8
        else:
            raise DicomError("%s: unsupported bits_allocated=%d" % (p, bits))

        frames = _decode_frame_pixels(f, p, rows, cols, bits, signed, dt, en, nf)

        # geometry: top-level tags for classic files; functional groups
        # (shared + per-frame) for enhanced multi-frame
        shared = f.get("shared_fg")
        shared_item = next(_iter_sq_items(shared, en), None) if shared else None
        perframe_items = (
            list(_iter_sq_items(f["perframe_fg"], en))
            if nf > 1 and "perframe_fg" in f
            else []
        )

        def fg_value(frame_idx, tag, top_key):
            if frame_idx < len(perframe_items):
                v = _find_tag(perframe_items[frame_idx], tag, en)
                if v is not None:
                    return v
            if shared_item is not None:
                v = _find_tag(shared_item, tag, en)
                if v is not None:
                    return v
            return f.get(top_key)

        if nf > 1 and not perframe_items and "ipp" not in f:
            raise DicomError(
                "%s: multi-frame file without per-frame plane positions — "
                "cannot order the slices" % p
            )

        for k in range(nf):
            # rescale can vary per frame in enhanced MR (the per-frame
            # PixelValueTransformationSequence)
            slope_b = fg_value(k, (0x0028, 0x1053), "rescale_slope")
            inter_b = fg_value(k, (0x0028, 0x1052), "rescale_intercept")
            slope = _ds(slope_b or b"1", [1.0])[0]
            inter = _ds(inter_b or b"0", [0.0])[0]
            img = frames[k].astype(np.float32) * slope + inter
            ipp = _ds(fg_value(k, (0x0020, 0x0032), "ipp") or b"0\\0\\0",
                      [0, 0, 0])
            iop = _ds(
                fg_value(k, (0x0020, 0x0037), "iop") or b"1\\0\\0\\0\\1\\0",
                [1, 0, 0, 0, 1, 0],
            )
            ps = _ds(fg_value(k, (0x0028, 0x0030), "pixel_spacing") or b"1\\1",
                     [1, 1])
            thick_b = (
                fg_value(k, (0x0018, 0x0088), "spacing_between")
                or fg_value(k, (0x0018, 0x0050), "slice_thickness")
                or b"1"
            )
            thick = _ds(thick_b, [1.0])[0]
            inst = int(
                _ds(f.get("instance_number", b"0"), [0])[0]
            ) * max(nf, 1) + k
            slices.append(
                (img, np.array(ipp), np.array(iop), ps, thick, inst)
            )

    if not slices:
        raise DicomError("no image slices found")

    iop = slices[0][2]
    normal = np.cross(iop[:3], iop[3:])
    slices.sort(key=lambda s: (float(np.dot(s[1], normal)), s[5]))

    vol = np.stack([s[0] for s in slices], axis=-1)  # [rows, cols, slices]
    ps = slices[0][3]
    if len(slices) > 1:
        zs = [float(np.dot(s[1], normal)) for s in slices]
        dz = float(np.median(np.diff(zs)))
        if abs(dz) < 1e-6:
            dz = slices[0][4]
    else:
        dz = slices[0][4]
    spacing = [float(ps[0]), float(ps[1]), abs(dz)]

    # LPS affine: columns = row-dir*ps_row? DICOM: iop[0:3] is direction of
    # increasing column index along a row... build with the standard mapping
    row_dir, col_dir = iop[:3], iop[3:]
    affine_lps = np.eye(4)
    affine_lps[:3, 0] = col_dir * ps[0]  # rows axis
    affine_lps[:3, 1] = row_dir * ps[1]  # cols axis
    affine_lps[:3, 2] = normal * dz
    affine_lps[:3, 3] = slices[0][1]
    # LPS -> RAS: negate x and y
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    affine_ras = flip @ affine_lps
    return vol, spacing, affine_ras


def convert_directory(input_dir: str, output_dir: str, compress=True, verbose=True):
    """Recursively group DICOM files by series and write one NIfTI each
    (the dcm2niix CLI role). Returns the list of written files."""
    from deepwmh_tpu_torch.core import nifti

    series = {}
    parsed = {}
    cached_bytes = 0
    # cache parsed files for series_to_volume (parse once, not twice), but
    # bounded: pinning every file's pixel bytes for a multi-GB study would
    # hold the whole directory in memory — past the budget the second
    # parse is the cheaper evil
    CACHE_BUDGET = 1 << 30
    for root, _dirs, files in os.walk(input_dir):
        for fn in files:
            p = os.path.join(root, fn)
            try:
                f = read_dicom(p)
            except Exception:
                continue
            sz = len(f.get("pixel_data", b"")) if isinstance(
                f.get("pixel_data"), (bytes, bytearray)
            ) else 0
            if cached_bytes + sz <= CACHE_BUDGET:
                parsed[p] = f
                cached_bytes += sz
            uid = f.get("series_uid", b"unknown").decode("ascii", "ignore").strip("\x00 ")
            series.setdefault(uid, []).append(p)

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for i, (uid, paths) in enumerate(sorted(series.items())):
        try:
            vol, spacing, affine = series_to_volume(paths, parsed=parsed)
        except native.NativeLibraryError:
            raise  # a missing toolchain is not a malformed series
        except Exception as e:
            # one malformed series (missing Rows, mixed slice shapes ->
            # KeyError/ValueError, not just DicomError) must not abort the
            # whole import batch
            if verbose:
                print("[skip] series %s: %r" % (uid[:16], e))
            continue
        finally:
            for p in paths:  # each series' cache is spent once converted
                parsed.pop(p, None)
        hdr = nifti.NiftiHeader()
        hdr.set_shape(vol.shape)
        hdr.set_zooms(tuple(spacing))
        hdr.srow = affine[:3, :]
        hdr.sform_code = 1
        ext = ".nii.gz" if compress else ".nii"
        out = os.path.join(output_dir, "series_%03d%s" % (i, ext))
        nifti.save_nifti(vol, hdr, out)
        written.append(out)
        if verbose:
            print("wrote %s (%d slice(s))" % (out, vol.shape[-1]))
    return written
