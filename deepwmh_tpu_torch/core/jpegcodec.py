"""From-scratch JPEG codec (ITU-T T.81) for DICOM pixel data.

The reference delegates compressed DICOM to the dcm2niix C++ binary
(deepwmh/external_tools/dcm2niix.py:54); this module internalizes the JPEG
transfer syntaxes that actually occur in MRI archives:

  decode():
    * SOF3  Lossless (Process 14) and its SV1 restriction — the DICOM
      syntaxes 1.2.840.10008.1.2.4.57 / .70.  All 7 predictors, point
      transform, restart intervals, 2-16 bit precision, 1-4 components
      (1x1 sampling when interleaved).
    * SOF0  Baseline DCT (Process 1, 8-bit) — 1.2.840.10008.1.2.4.50.
    * SOF1  Extended sequential DCT (Process 2&4, 8/12-bit) —
      1.2.840.10008.1.2.4.51.  Grayscale and YCbCr, 1x1/2x1/2x2 sampling,
      restart intervals.

  encode_lossless() / encode_dct():
    matching encoders (optimal per-image Huffman tables built with the
    Annex K.2 procedure) used for exact round-trip tests and artifact
    compression.

Host code (numpy + Python): the DICOM import path, not the card's. The
single-component lossless fast path runs its Huffman pass and (predictors
2-7) its reconstruction in native C++ (``native/jpegl.cpp``); the Python
versions ``_decode_diffs_py`` and ``_reconstruct_py`` are the plain
versions it is held against, and decide when the library declines a
stream.
"""

from __future__ import annotations

import struct

import numpy as np

from deepwmh_tpu_torch import native

# marker codes
SOI, EOI, SOS, DQT, DNL, DRI, COM = 0xD8, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE
DHT = 0xC4
SOF0, SOF1, SOF2, SOF3 = 0xC0, 0xC1, 0xC2, 0xC3
SOF5, SOF6, SOF7 = 0xC5, 0xC6, 0xC7
SOF9, SOF10, SOF11, SOF13, SOF14, SOF15 = 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF
RST0, RST7 = 0xD0, 0xD7
_SOF_ALL = {SOF0, SOF1, SOF2, SOF3, SOF5, SOF6, SOF7, SOF9, SOF10, SOF11, SOF13, SOF14, SOF15}

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)
_UNZIGZAG = np.argsort(_ZIGZAG)

# ITU-T T.81 Annex K.1 luminance quantization table (zigzag order applied later)
_STD_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)


class JpegError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------


def _huff_lut_np(bits, values):
    """16-bit-peek decode LUT: lut[p] = (symbol << 5) | code_length, 0 when
    no code is a prefix of p. bits = 16 counts, values = symbols in code
    order (canonical JPEG Huffman, T.81 Annex C)."""
    lut = np.zeros(65536, np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            sym = values[k]
            k += 1
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (int(sym) << 5) | length
            code += 1
        if code > (1 << length):
            raise JpegError("invalid Huffman table (code overflow)")
        code <<= 1
    return lut


def _huff_lut(bits, values):
    # Python list indexing beats ndarray scalar indexing in the bit loops
    return _huff_lut_np(bits, values).tolist()


def _huff_codes(bits, values):
    """Encoder view: symbol -> (code, length)."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[int(values[k])] = (code, length)
            k += 1
            code += 1
        code <<= 1
    return table


def _build_huffman(freq):
    """Optimal length-limited JPEG Huffman table from symbol frequencies —
    the Annex K.2 procedure (Figures K.1-K.3): merge the two least-frequent
    live symbols, track code sizes, then fold lengths > 16 down.
    Returns (bits[16], values)."""
    nsym = len(freq)
    freq = list(freq) + [1]  # reserved symbol guarantees no all-ones code
    others = [-1] * len(freq)
    codesize = [0] * len(freq)
    while True:
        live = [i for i, f in enumerate(freq) if f > 0]
        if len(live) <= 1:
            if live:
                codesize[live[0]] = max(codesize[live[0]], 1)
            break
        live.sort(key=lambda i: (freq[i], i))
        v1, v2 = live[0], live[1]
        freq[v1] += freq[v2]
        freq[v2] = 0
        while True:
            codesize[v1] += 1
            if others[v1] < 0:
                break
            v1 = others[v1]
        others[v1] = v2
        while True:
            codesize[v2] += 1
            if others[v2] < 0:
                break
            v2 = others[v2]
    counts = [0] * 33
    for s in codesize:
        if s:
            counts[min(s, 32)] += 1
    # Figure K.3: fold lengths >16 into shorter ones
    i = 32
    while i > 16:
        while counts[i] > 0:
            j = i - 2
            while counts[j] == 0:
                j -= 1
            counts[i] -= 2
            counts[i - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
        i -= 1
    # drop one count for the reserved symbol (longest code)
    i = 16
    while counts[i] == 0:
        i -= 1
    counts[i] -= 1
    bits = counts[1:17]
    order = sorted(
        (i for i in range(nsym) if codesize[i] > 0),
        key=lambda i: (codesize[i], i),
    )
    return bits, order


# ---------------------------------------------------------------------------
# Bit I/O
# ---------------------------------------------------------------------------


def _unstuff(seg: bytes) -> bytes:
    """Remove 0x00 stuffing bytes that follow 0xFF in entropy-coded data."""
    if b"\xff" not in seg:
        return seg
    a = np.frombuffer(seg, np.uint8)
    drop = np.zeros(len(a), bool)
    drop[1:] = (a[:-1] == 0xFF) & (a[1:] == 0x00)
    return a[~drop].tobytes()


class _BitReader:
    __slots__ = ("buf", "n", "pos", "acc", "bits")

    def __init__(self, data: bytes):
        self.buf = data
        self.n = len(data)
        self.pos = 0
        self.acc = 0
        self.bits = 0

    def fill(self, need):
        while self.bits < need:
            b = self.buf[self.pos] if self.pos < self.n else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.bits += 8

    def get(self, k):
        if k == 0:
            return 0
        if self.bits < k:
            self.fill(k)
        self.bits -= k
        v = (self.acc >> self.bits) & ((1 << k) - 1)
        self.acc &= (1 << self.bits) - 1
        return v

    def decode(self, lut):
        if self.bits < 16:
            self.fill(16)
        e = lut[(self.acc >> (self.bits - 16)) & 0xFFFF]
        if e == 0:
            raise JpegError("invalid Huffman code in entropy data")
        length = e & 31
        self.bits -= length
        self.acc &= (1 << self.bits) - 1
        return e >> 5


class _BitWriter:
    __slots__ = ("out", "acc", "bits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.bits = 0

    def put(self, code, length):
        if length == 0:
            return
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.bits += length
        while self.bits >= 8:
            self.bits -= 8
            b = (self.acc >> self.bits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
        self.acc &= (1 << self.bits) - 1

    def flush(self):
        if self.bits:
            self.put(0xFF, 8 - self.bits)  # pad with 1s (F.1.2.3)


def _extend(v, s):
    """T.81 F.2.2.1 EXTEND: map s low-order bits to a signed value."""
    if s == 0:
        return 0
    return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


def _category(d):
    """Number of bits needed for the signed value d (SSSS)."""
    return int(abs(d)).bit_length()


# ---------------------------------------------------------------------------
# Stream parsing
# ---------------------------------------------------------------------------


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "td", "ta")


def _parse_stream(data: bytes):
    """Walk the marker stream. Returns a dict with frame header info, tables,
    restart interval, scans [(scan_header, entropy_bytes)], sof marker."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != SOI:
        raise JpegError("not a JPEG stream (missing SOI)")
    st = {
        "qt": {}, "huff_dc": {}, "huff_ac": {}, "ri": 0,
        "scans": [], "sof": None,
    }
    i = 2
    n = len(data)
    while i < n:
        if data[i] != 0xFF:
            raise JpegError("marker expected at offset %d" % i)
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            break
        m = data[i]
        i += 1
        if m == EOI:
            break
        if RST0 <= m <= RST7 or m == 0x01:
            continue
        (seglen,) = struct.unpack_from(">H", data, i)
        seg = data[i + 2 : i + seglen]
        i += seglen
        if m in _SOF_ALL:
            if m not in (SOF0, SOF1, SOF3):
                kind = {SOF2: "progressive DCT"}.get(m, "SOF%d" % (m - 0xC0))
                raise JpegError(
                    "unsupported JPEG process (%s); supported: baseline, "
                    "extended sequential, lossless" % kind
                )
            st["sof"] = m
            precision, height, width, ncomp = struct.unpack_from(">BHHB", seg, 0)
            comps = []
            for c in range(ncomp):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * c)
                comp = _Component()
                comp.cid, comp.h, comp.v, comp.tq = cid, hv >> 4, hv & 15, tq
                comps.append(comp)
            st.update(precision=precision, height=height, width=width, comps=comps)
        elif m == DHT:
            j = 0
            while j < len(seg):
                tc_th = seg[j]
                bits = list(seg[j + 1 : j + 17])
                nv = sum(bits)
                values = list(seg[j + 17 : j + 17 + nv])
                j += 17 + nv
                dest = st["huff_dc"] if (tc_th >> 4) == 0 else st["huff_ac"]
                dest[tc_th & 15] = (bits, values)
        elif m == DQT:
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                j += 1
                if pq == 0:
                    qt = np.frombuffer(seg[j : j + 64], np.uint8).astype(np.int32)
                    j += 64
                else:
                    qt = np.frombuffer(seg[j : j + 128], ">u2").astype(np.int32)
                    j += 128
                st["qt"][tq] = qt
        elif m == DRI:
            (st["ri"],) = struct.unpack_from(">H", seg, 0)
        elif m == SOS:
            ns = seg[0]
            sel = []
            for c in range(ns):
                cs, tdta = seg[1 + 2 * c], seg[2 + 2 * c]
                sel.append((cs, tdta >> 4, tdta & 15))
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            # entropy data runs until the next non-RST, non-stuffing marker
            a = np.frombuffer(data, np.uint8)
            ffs = np.flatnonzero(a[i:-1] == 0xFF) + i
            nxt = a[ffs + 1] if len(ffs) else np.array([], np.uint8)
            stop = ffs[(nxt != 0x00) & ~((nxt >= RST0) & (nxt <= RST7))]
            j = int(stop[0]) if len(stop) else n
            st["scans"].append(((sel, ss, se, ahal >> 4, ahal & 15), data[i:j]))
            i = j
        # APPn / COM / DNL: skipped
    if st["sof"] is None or not st["scans"]:
        raise JpegError("no frame/scan found in JPEG stream")
    return st


def _split_restarts(entropy: bytes):
    """Split entropy-coded data at restart markers, unstuffing each chunk."""
    a = np.frombuffer(entropy, np.uint8)
    if len(a) < 2:
        return [_unstuff(entropy)]
    ffs = np.flatnonzero(a[:-1] == 0xFF)
    nxt = a[ffs + 1]
    rsts = ffs[(nxt >= RST0) & (nxt <= RST7)]
    chunks = []
    start = 0
    for r in rsts:
        chunks.append(_unstuff(entropy[start:r]))
        start = int(r) + 2
    chunks.append(_unstuff(entropy[start:]))
    return chunks


# ---------------------------------------------------------------------------
# Lossless (SOF3) decode — T.81 Annex H
# ---------------------------------------------------------------------------


def _predict(ra, rb, rc, psv):
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    if psv == 7:
        return (ra + rb) >> 1
    raise JpegError("invalid lossless predictor %d" % psv)


def _decode_lossless(st):
    precision = st["precision"]
    height, width = st["height"], st["width"]
    comps = st["comps"]
    (sel, psv, _se, _ah, pt), entropy = st["scans"][0]
    if any(c.h != 1 or c.v != 1 for c in comps) and len(comps) > 1:
        raise JpegError("lossless: only 1x1 sampling supported for Ns>1")
    ncomp = len(sel)
    luts = []
    for _cs, td, _ta in sel:
        if td not in st["huff_dc"]:
            raise JpegError("missing Huffman table %d" % td)
        luts.append(_huff_lut(*st["huff_dc"][td]))

    default = 1 << (precision - pt - 1)
    out = np.zeros((ncomp, height, width), np.int64)
    chunks = _split_restarts(entropy)
    total = height * width
    ri = st["ri"] or total  # MCUs (samples, for 1x1 sampling) per interval
    if st["ri"] and st["ri"] % width != 0:
        # T.81 H.1.2.2 treats each restart interval like a new scan; only
        # row-aligned intervals have an unambiguous "first line"
        raise JpegError(
            "lossless restart interval %d is not a multiple of the line "
            "width %d" % (st["ri"], width)
        )

    done = 0
    for chunk in chunks:
        br = _BitReader(chunk)
        count = min(ri, total - done)
        r0 = done // width  # interval starts at column 0 (row-aligned)
        for k in range(count):
            y, x = divmod(done + k, width)
            for ci in range(ncomp):
                s = br.decode(luts[ci])
                if s == 16:
                    diff = 32768
                elif s == 0:
                    diff = 0
                else:
                    diff = _extend(br.get(s), s)
                plane = out[ci]
                if y == r0:  # first line of the scan / restart interval: Ra
                    pred = default if x == 0 else int(plane[y, x - 1])
                elif x == 0:  # start of line: Rb
                    pred = int(plane[y - 1, 0])
                else:
                    pred = _predict(
                        int(plane[y, x - 1]),
                        int(plane[y - 1, x]),
                        int(plane[y - 1, x - 1]),
                        psv,
                    )
                plane[y, x] = (pred + diff) & 0xFFFF  # mod 2^16 (H.2.1)
        done += count
    out = (out << pt).astype(np.uint16 if precision > 8 else np.uint8)
    if ncomp == 1:
        return out[0], precision
    return np.moveaxis(out, 0, -1), precision


def _decode_diffs_py(data: bytes, lut_np: np.ndarray, n: int) -> np.ndarray:
    """Serial Huffman pass in Python: the plain version of
    native/jpegl.cpp's ``jpegl_decode_diffs``."""
    native.count("jpegl_decode_diffs", python=True)
    lut = lut_np.tolist()
    br = _BitReader(data)
    diffs = np.empty(n, np.int64)
    dec = br.decode
    get = br.get
    ext = _extend
    for i in range(n):
        s = dec(lut)
        if s == 0:
            diffs[i] = 0
        elif s == 16:
            diffs[i] = 32768
        else:
            diffs[i] = ext(get(s), s)
    return diffs


def _decode_lossless_1comp_fast(st):
    """Fast path for the dominant DICOM case: 1 component, no restart
    intervals. The serial Huffman pass runs in native code
    (native/jpegl.cpp); reconstruction is two numpy cumsums for predictor 1
    (SV1) or the native sequential kernel otherwise. Python decides only
    where the library declines the stream."""
    precision = st["precision"]
    height, width = st["height"], st["width"]
    (sel, psv, _se, _ah, pt), entropy = st["scans"][0]
    td = sel[0][1]
    lut_np = _huff_lut_np(*st["huff_dc"][td])
    data = _unstuff(entropy)
    n = height * width
    default = 1 << (precision - pt - 1)

    diffs = native.jpegl_decode_diffs_host(data, lut_np, n)
    if diffs is None:
        diffs = _decode_diffs_py(data, lut_np, n)

    if psv == 1:
        d = diffs.reshape(height, width).copy()
        # first column: predicted from the sample above (Rb); row 0 col 0
        # from the default. With predictor Ra the rest is a row prefix sum.
        d[:, 0] = np.cumsum(d[:, 0]) + default
        out = np.cumsum(d, axis=1) & 0xFFFF
    else:
        out = native.jpegl_reconstruct_host(diffs, height, width, psv, default)
        if out is None:
            out = _reconstruct_py(diffs.reshape(height, width), psv, default)
    out = (out << pt).astype(np.uint16 if precision > 8 else np.uint8)
    return out, precision


def _reconstruct_py(d, psv, default):
    """Sequential predictor reconstruction in Python: the plain version of
    native/jpegl.cpp's ``jpegl_reconstruct``."""
    native.count("jpegl_reconstruct", python=True)
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        for x in range(w):
            if y == 0:
                pred = default if x == 0 else int(out[0, x - 1])
            elif x == 0:
                pred = int(out[y - 1, 0])
            else:
                pred = _predict(
                    int(out[y, x - 1]), int(out[y - 1, x]),
                    int(out[y - 1, x - 1]), psv,
                )
            out[y, x] = (pred + int(d[y, x])) & 0xFFFF
    return out


# ---------------------------------------------------------------------------
# Sequential DCT (SOF0/SOF1) decode — T.81 Annex F
# ---------------------------------------------------------------------------

_DCT_M = None


def _dct_matrix():
    global _DCT_M
    if _DCT_M is None:
        k = np.arange(8)
        _DCT_M = np.sqrt(2.0 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
        _DCT_M[0] *= 1 / np.sqrt(2)
    return _DCT_M


def _idct_blocks(blocks):
    """blocks [N, 8, 8] natural order -> spatial [N, 8, 8] (float64)."""
    m = _dct_matrix()
    return np.einsum("ij,njk,kl->nil", m.T, blocks, m)


def _fdct_blocks(blocks):
    m = _dct_matrix()
    return np.einsum("ij,njk,kl->nil", m, blocks, m.T)


def _decode_dct(st):
    precision = st["precision"]
    height, width = st["height"], st["width"]
    comps = st["comps"]
    (sel, _ss, _se, _ah, _al), entropy = st["scans"][0]
    if len(sel) != len(comps):
        raise JpegError("non-interleaved multi-scan DCT not supported")
    by_id = {c.cid: c for c in comps}
    for cs, td, ta in sel:
        by_id[cs].td, by_id[cs].ta = td, ta
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))

    dc_luts = {t: _huff_lut(*bv) for t, bv in st["huff_dc"].items()}
    ac_luts = {t: _huff_lut(*bv) for t, bv in st["huff_ac"].items()}

    # per-component coefficient store in zigzag order
    coefs = [
        np.zeros((mcuy * c.v, mcux * c.h, 64), np.int32) for c in comps
    ]
    chunks = _split_restarts(entropy)
    ri = st["ri"] or (mcux * mcuy)
    mcu = 0
    n_mcu = mcux * mcuy
    for chunk in chunks:
        br = _BitReader(chunk)
        preds = [0] * len(comps)
        count = min(ri, n_mcu - mcu)
        for k in range(mcu, mcu + count):
            my, mx = divmod(k, mcux)
            for ci, c in enumerate(comps):
                dlut, alut = dc_luts[c.td], ac_luts[c.ta]
                for v in range(c.v):
                    for h in range(c.h):
                        blk = coefs[ci][my * c.v + v, mx * c.h + h]
                        s = br.decode(dlut)
                        preds[ci] += _extend(br.get(s), s) if s else 0
                        blk[0] = preds[ci]
                        j = 1
                        while j < 64:
                            rs = br.decode(alut)
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    j += 16  # ZRL
                                    continue
                                break  # EOB
                            j += r
                            if j > 63:
                                raise JpegError("AC run past end of block")
                            blk[j] = _extend(br.get(s), s)
                            j += 1
        mcu += count

    shift = 1 << (precision - 1)
    top = (1 << precision) - 1
    planes = []
    for ci, c in enumerate(comps):
        qt = st["qt"][c.tq]
        z = coefs[ci].reshape(-1, 64) * qt[None, :]
        nat = np.zeros_like(z)
        nat[:, _ZIGZAG] = z  # zigzag -> natural
        spat = _idct_blocks(nat.reshape(-1, 8, 8).astype(np.float64))
        by, bx = mcuy * c.v, mcux * c.h
        plane = (
            spat.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        )
        plane = np.clip(np.round(plane) + shift, 0, top)
        # upsample to full frame grid
        if c.h != hmax:
            plane = np.repeat(plane, hmax // c.h, axis=1)
        if c.v != vmax:
            plane = np.repeat(plane, vmax // c.v, axis=0)
        planes.append(plane[:height, :width])

    dtype = np.uint16 if precision > 8 else np.uint8
    if len(planes) == 1:
        return planes[0].astype(dtype), precision
    if len(planes) == 3:  # YCbCr -> RGB (JFIF)
        y, cb, cr = planes
        cb, cr = cb - shift, cr - shift
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        rgb = np.stack([r, g, b], -1)
        return np.clip(np.round(rgb), 0, top).astype(dtype), precision
    return np.stack(planes, -1).astype(dtype), precision


def decode(data: bytes):
    """Decode a JPEG byte stream. Returns (image, precision): image is
    [rows, cols] (grayscale) or [rows, cols, ncomp], uint8 for precision<=8
    else uint16."""
    st = _parse_stream(bytes(data))
    if st["sof"] == SOF3:
        (sel, _psv, _se, _ah, _pt), _ = st["scans"][0]
        if len(st["scans"]) > 1 or len(sel) < len(st["comps"]):
            # one scan per component (non-interleaved): decoding scans[0]
            # alone would silently return a single-component image
            raise JpegError(
                "non-interleaved multi-scan lossless JPEG not supported "
                "(%d scan(s) for %d component(s))"
                % (len(st["scans"]), len(st["comps"]))
            )
        if len(sel) == 1 and st["ri"] == 0:
            return _decode_lossless_1comp_fast(st)
        return _decode_lossless(st)
    return _decode_dct(st)


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def _marker(m, payload=b""):
    if payload:
        return struct.pack(">BBH", 0xFF, m, len(payload) + 2) + payload
    return struct.pack(">BB", 0xFF, m)


def _dht_segment(tc, th, bits, values):
    return _marker(DHT, bytes([tc << 4 | th] + bits + list(values)))


def encode_lossless(img, predictor: int = 1, point_transform: int = 0,
                    precision: int | None = None, restart_interval: int = 0) -> bytes:
    """Encode a 2D grayscale image as JPEG Lossless (SOF3). predictor=1 is
    the SV1 restriction (DICOM 1.2.840.10008.1.2.4.70). Exact round-trip
    with decode()."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise JpegError("encode_lossless: 2D grayscale only")
    if precision is None:
        precision = max(2, int(img.max()).bit_length()) if img.size else 8
    if precision < 2 or precision > 16:
        raise JpegError("precision must be in [2, 16]")
    pt = point_transform
    x = (img.astype(np.int64) >> pt) if pt else img.astype(np.int64)
    h, w = x.shape

    # vectorized prediction (reconstructed == original for lossless)
    ra = np.empty_like(x); ra[:, 1:] = x[:, :-1]; ra[:, 0] = 0
    rb = np.empty_like(x); rb[1:, :] = x[:-1, :]; rb[0, :] = 0
    rc = np.empty_like(x); rc[1:, 1:] = x[:-1, :-1]; rc[0, :] = 0; rc[:, 0] = 0
    pred = {
        1: lambda: ra,
        2: lambda: rb,
        3: lambda: rc,
        4: lambda: ra + rb - rc,
        5: lambda: ra + ((rb - rc) >> 1),
        6: lambda: rb + ((ra - rc) >> 1),
        7: lambda: (ra + rb) >> 1,
    }[predictor]()
    pred[0, 1:] = x[0, :-1]   # first line: Ra
    pred[1:, 0] = x[:-1, 0]   # first column: Rb
    pred[0, 0] = 1 << (precision - pt - 1)
    if restart_interval:
        if restart_interval % w != 0:
            raise JpegError(
                "lossless restart interval must be a multiple of the image "
                "width (each interval starts a new 'first line', H.1.2.2)"
            )
        for r0 in range(restart_interval // w, h, restart_interval // w):
            # interval start behaves like a new scan: default then Ra
            if w > 1:
                pred[r0, 1:] = x[r0, :-1]
            pred[r0, 0] = 1 << (precision - pt - 1)

    diffs = (x - pred) & 0xFFFF
    sd = np.where(diffs >= 32768, diffs - 65536, diffs)  # signed window
    # category = bit_length(|d|) = ceil(log2(|d|+1)); exact in float64 for
    # |d| <= 2^16 (integers and powers of two are represented exactly)
    cats = np.ceil(np.log2(np.abs(sd).astype(np.float64) + 1.0)).astype(np.int64)
    cats[diffs == 32768] = 16  # SSSS=16: diff 32768, no extra bits (H.2)

    freq = np.bincount(cats.reshape(-1), minlength=17)
    bits, values = _build_huffman(freq.tolist())
    codes = _huff_codes(bits, values)

    out = bytearray()
    out += _marker(SOI)
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0])
    out += _marker(SOF3, sof)
    out += _dht_segment(0, 0, bits, values)
    if restart_interval:
        out += _marker(DRI, struct.pack(">H", restart_interval))
    out += _marker(SOS, bytes([1, 1, 0x00, predictor, 0, pt << 0]))

    bw = _BitWriter()
    flat_c = cats.reshape(-1)
    flat_d = sd.reshape(-1)
    n = h * w
    ri = restart_interval or n
    rst = 0
    pos = 0
    while pos < n:
        end = min(pos + ri, n)
        for i in range(pos, end):
            s = int(flat_c[i])
            code, length = codes[s]
            bw.put(code, length)
            if s and s != 16:
                d = int(flat_d[i])
                if d < 0:
                    d += (1 << s) - 1
                bw.put(d, s)
        pos = end
        if pos < n:
            bw.flush()
            out += bytes(bw.out)
            bw = _BitWriter()
            out += struct.pack(">BB", 0xFF, RST0 + (rst & 7))
            rst += 1
    bw.flush()
    out += bytes(bw.out)
    out += _marker(EOI)
    return bytes(out)


def _quant_table(quality, precision):
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    qt = np.clip((_STD_QT * scale + 50) // 100, 1, None)
    if precision > 8:
        qt = qt * (1 << (precision - 8))
    return np.clip(qt, 1, 65535 if precision > 8 else 255).astype(np.int64)


def encode_dct(img, quality: int = 90, precision: int = 8,
               restart_interval: int = 0) -> bytes:
    """Encode a 2D grayscale image as sequential DCT JPEG: SOF0 (baseline)
    for 8-bit, SOF1 (extended) for 12-bit — the DICOM .50/.51 syntaxes."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise JpegError("encode_dct: 2D grayscale only")
    if precision not in (8, 12):
        raise JpegError("DCT precision must be 8 or 12")
    h, w = img.shape
    qt = _quant_table(quality, precision)

    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    pad = np.pad(img.astype(np.float64), ((0, ph - h), (0, pw - w)), mode="edge")
    blocks = (
        pad.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    )
    blocks -= 1 << (precision - 1)
    coef = _fdct_blocks(blocks).reshape(-1, 64)
    zz = coef[:, _ZIGZAG]
    q = np.round(zz / qt[None, :]).astype(np.int64)

    nb = q.shape[0]
    dc = q[:, 0].copy()
    dc[1:] -= q[:-1, 0]
    ri_blocks = restart_interval or nb
    # restart resets the DC predictor
    for s in range(ri_blocks, nb, ri_blocks):
        dc[s] = q[s, 0]

    def cat(v):
        return int(abs(int(v))).bit_length()

    # first pass: symbol stats
    dc_freq = [0] * 17
    ac_freq = [0] * 256
    runs = []  # per block: list of (rs, s, val)
    for b in range(nb):
        dc_freq[cat(dc[b])] += 1
        row = q[b]
        sym = []
        run = 0
        last = 63
        while last > 0 and row[last] == 0:
            last -= 1
        for j in range(1, last + 1):
            v = int(row[j])
            if v == 0:
                run += 1
                continue
            while run > 15:
                sym.append((0xF0, 0, 0))
                ac_freq[0xF0] += 1
                run -= 16
            s = cat(v)
            rs = (run << 4) | s
            sym.append((rs, s, v))
            ac_freq[rs] += 1
            run = 0
        if last < 63:
            sym.append((0x00, 0, 0))
            ac_freq[0x00] += 1
        runs.append(sym)

    dbits, dvals = _build_huffman(dc_freq)
    abits, avals = _build_huffman(ac_freq)
    dcodes = _huff_codes(dbits, dvals)
    acodes = _huff_codes(abits, avals)

    out = bytearray()
    out += _marker(SOI)
    if precision == 8:
        out += _marker(DQT, bytes([0x00]) + bytes(qt.astype(np.uint8).tolist()))
    else:
        out += _marker(DQT, bytes([0x10]) + b"".join(struct.pack(">H", int(v)) for v in qt))
    sofm = SOF0 if precision == 8 else SOF1
    out += _marker(sofm, struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0]))
    out += _dht_segment(0, 0, dbits, dvals)
    out += _dht_segment(1, 0, abits, avals)
    if restart_interval:
        out += _marker(DRI, struct.pack(">H", restart_interval))
    out += _marker(SOS, bytes([1, 1, 0x00, 0, 63, 0]))

    bw = _BitWriter()
    rst = 0
    for b in range(nb):
        if restart_interval and b and b % ri_blocks == 0:
            bw.flush()
            out += bytes(bw.out)
            bw = _BitWriter()
            out += struct.pack(">BB", 0xFF, RST0 + (rst & 7))
            rst += 1
        s = cat(dc[b])
        code, length = dcodes[s]
        bw.put(code, length)
        if s:
            d = int(dc[b])
            if d < 0:
                d += (1 << s) - 1
            bw.put(d, s)
        for rs, s2, v in runs[b]:
            code, length = acodes[rs]
            bw.put(code, length)
            if s2:
                if v < 0:
                    v += (1 << s2) - 1
                bw.put(v, s2)
    bw.flush()
    out += bytes(bw.out)
    out += _marker(EOI)
    return bytes(out)
