"""From-scratch JPEG-LS codec (ITU-T T.87 / ISO 14495-1, LOCO-I).

Covers the DICOM transfer syntaxes 1.2.840.10008.1.2.4.80 (JPEG-LS
Lossless, NEAR=0) and .81 (JPEG-LS Near-Lossless, NEAR>0) that the
reference hands to the dcm2niix binary's embedded CharLS
(deepwmh/external_tools/dcm2niix.py:54). Single-component scans (the MRI
case), 2-16 bit precision, default or LSE preset parameters, full
context-modelling pipeline: gradient quantization into 365 regular
contexts, median-edge-detection prediction with bias correction,
limited-length Golomb coding, run mode with the J[] melcode ladder and
run-interruption contexts 365/366, and 0xFF bit-stuffing marker
prevention.

encode() exists primarily so decode() can be exercised by exact round
trips (no independent JPEG-LS implementation is available in this
environment); both sides are written independently from the T.87
procedures (A.2-A.8) rather than sharing a transform, so a decode bug
cannot silently cancel against its encode mirror.
"""

from __future__ import annotations

import struct

import numpy as np

from deepwmh_tpu_torch import native


class JlsError(ValueError):
    pass


SOI, EOI, SOS, LSE = 0xD8, 0xD9, 0xDA, 0xF8
SOF55 = 0xF7

# A.7.1.1 run-length code ladder
_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
     4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]

MIN_C, MAX_C = -128, 127


def _default_thresholds(maxval, near):
    """C.2.4.1.1.1 default T1/T2/T3 and RESET."""
    def clamp(v, lo):
        return min(max(v, lo), maxval)

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3, 64


class _Params:
    def __init__(self, precision, width, height, near=0, maxval=None,
                 t1=None, t2=None, t3=None, reset=None):
        self.P = precision
        self.w = width
        self.h = height
        self.near = near
        self.maxval = maxval if maxval is not None else (1 << precision) - 1
        d1, d2, d3, dr = _default_thresholds(self.maxval, near)
        self.t1 = t1 if t1 else d1
        self.t2 = t2 if t2 else d2
        self.t3 = t3 if t3 else d3
        self.reset = reset if reset else dr
        self.range = (self.maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        self.bpp = max(2, (self.maxval).bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))


class _State:
    """Context state (A.8 initialization)."""

    def __init__(self, p: _Params):
        a0 = max(2, (p.range + 32) // 64)
        self.A = [a0] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]  # run-interruption negative counts (contexts 365/366)


def _quantize_gradient(d, t1, t2, t3, near):
    if d <= -t3:
        return -4
    if d <= -t2:
        return -3
    if d <= -t1:
        return -2
    if d < -near:
        return -1
    if d <= near:
        return 0
    if d < t1:
        return 1
    if d < t2:
        return 2
    if d < t3:
        return 3
    return 4


def _mod_range(errval, rng):
    """A.4.5 modulo reduction into [-floor(range/2), ceil(range/2)-1]."""
    if errval < 0:
        errval += rng
    if errval >= (rng + 1) // 2:
        errval -= rng
    return errval


# ---------------------------------------------------------------------------
# bit I/O with 0xFF marker prevention (A.1: byte after 0xFF carries 7 bits)
# ---------------------------------------------------------------------------


class _JlsBitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0
        self.ff = False  # last emitted byte was 0xFF

    def put(self, value, nbits):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        self._drain()

    def _drain(self):
        while True:
            width = 7 if self.ff else 8
            if self.nbits < width:
                return
            b = (self.acc >> (self.nbits - width)) & ((1 << width) - 1)
            self.nbits -= width
            self.acc &= (1 << self.nbits) - 1
            self.out.append(b)  # 7-bit payload has MSB 0 automatically
            self.ff = b == 0xFF

    def flush(self):
        width = 7 if self.ff else 8
        if self.nbits:
            pad = width - self.nbits
            self.put(0, pad)  # zero padding cannot fabricate a marker


class _JlsBitReader:
    def __init__(self, data: bytes):
        self.buf = data
        self.n = len(data)
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.ff = False

    def _fill(self, need):
        while self.nbits < need:
            if self.pos >= self.n:
                self.acc <<= 8
                self.nbits += 8
                continue
            b = self.buf[self.pos]
            self.pos += 1
            if self.ff:
                # 7-bit payload byte; MSB 1 would mean a real marker
                self.acc = (self.acc << 7) | (b & 0x7F)
                self.nbits += 7
            else:
                self.acc = (self.acc << 8) | b
                self.nbits += 8
            self.ff = b == 0xFF

    def get(self, k):
        if k == 0:
            return 0
        self._fill(k)
        self.nbits -= k
        v = (self.acc >> self.nbits) & ((1 << k) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def unary(self):
        """Count zeros until the first 1 bit (consuming it)."""
        count = 0
        while True:
            self._fill(1)
            self.nbits -= 1
            bit = (self.acc >> self.nbits) & 1
            self.acc &= (1 << self.nbits) - 1
            if bit:
                return count
            count += 1
            if count > 64:  # corrupt stream guard (limit is < 2*bpp+16)
                raise JlsError("runaway unary code (corrupt stream)")


def _golomb_encode(bw, value, k, limit, qbpp):
    """A.5.3 limited-length Golomb."""
    high = value >> k
    if high < limit - qbpp - 1:
        bw.put(1, high + 1)  # `high` zeros then a 1
        if k:
            bw.put(value & ((1 << k) - 1), k)
    else:
        bw.put(1, limit - qbpp)  # limit-qbpp-1 zeros then a 1
        bw.put(value - 1, qbpp)


def _golomb_decode(br, k, limit, qbpp):
    high = br.unary()
    if high < limit - qbpp - 1:
        return (high << k) | br.get(k)
    if high != limit - qbpp - 1:
        raise JlsError("invalid limited Golomb prefix")
    return br.get(qbpp) + 1


# ---------------------------------------------------------------------------
# core codec (single component)
# ---------------------------------------------------------------------------


def _k_for(n, a):
    k = 0
    while (n << k) < a:
        k += 1
    return k


def _update_regular(st, q, errval, near, reset):
    """A.6.1 state update + A.6.2 bias computation."""
    st.B[q] += errval * (2 * near + 1)
    st.A[q] += abs(errval)
    if st.N[q] == reset:
        st.A[q] >>= 1
        st.B[q] = st.B[q] >> 1 if st.B[q] >= 0 else -((1 - st.B[q]) >> 1)
        st.N[q] >>= 1
    st.N[q] += 1
    if st.B[q] <= -st.N[q]:
        st.B[q] += st.N[q]
        if st.C[q] > MIN_C:
            st.C[q] -= 1
        if st.B[q] <= -st.N[q]:
            st.B[q] = -st.N[q] + 1
    elif st.B[q] > 0:
        st.B[q] -= st.N[q]
        if st.C[q] < MAX_C:
            st.C[q] += 1
        if st.B[q] > 0:
            st.B[q] = 0


def _codec(img_or_none, br_or_bw, p: _Params, decode: bool):
    """One pass over the sample grid — shared control flow, with encode and
    decode branching only at the entropy-coding leaves (the per-sample
    arithmetic follows T.87 A.2-A.8 in both directions)."""
    st = _State(p)
    w, h = p.w, p.h
    near, rng, reset = p.near, p.range, p.reset
    maxval, limit, qbpp = p.maxval, p.limit, p.qbpp
    t1, t2, t3 = p.t1, p.t2, p.t3

    out = np.zeros((h, w), np.int64) if decode else None
    src = None if decode else np.asarray(img_or_none, np.int64)
    bw = None if decode else br_or_bw
    br = br_or_bw if decode else None

    prev = [0] * (w + 2)  # index 0: left edge; 1..w: samples; w+1: right pad
    cur = [0] * (w + 2)
    run_index = 0

    for y in range(h):
        cur[0] = prev[1]  # Ra at column 0 = Rb
        x = 1
        while x <= w:
            ra, rb, rc, rd = cur[x - 1], prev[x], prev[x - 1], prev[x + 1]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            q1 = _quantize_gradient(d1, t1, t2, t3, near)
            q2 = _quantize_gradient(d2, t1, t2, t3, near)
            q3 = _quantize_gradient(d3, t1, t2, t3, near)

            if q1 == 0 and q2 == 0 and q3 == 0:
                # ---- run mode (A.7) ----
                if decode:
                    while True:
                        if br.get(1) == 1:
                            count = 1 << _J[run_index]
                            fill = min(count, w - x + 1)
                            for _ in range(fill):
                                cur[x] = ra
                                x += 1
                            if fill == count:
                                # full segment: bump the ladder; if the line
                                # continues another run bit follows
                                if run_index < 31:
                                    run_index += 1
                                if x > w:
                                    break
                                continue
                            # '1' with a partial fill = run terminated by
                            # the end of the line (A.7.1.2): RUNindex stays
                            break
                        # '0' bit: remainder then interruption sample
                        rem = br.get(_J[run_index]) if _J[run_index] else 0
                        if x + rem > w:  # interruption sample must also fit
                            raise JlsError("run remainder past end of line")
                        for _ in range(rem):
                            cur[x] = ra
                            x += 1
                        rb = prev[x]
                        val = _ri_decode(br, st, ra, rb, p, run_index)
                        cur[x] = val
                        x += 1
                        if run_index > 0:
                            run_index -= 1
                        break
                else:
                    # encode: count the run of samples ~= Ra
                    run = 0
                    while x + run <= w and abs(int(src[y, x + run - 1]) - ra) <= near:
                        run += 1
                    # near-lossless: run samples reconstruct to Ra
                    i = x
                    for _ in range(run):
                        cur[i] = ra
                        i += 1
                    x_end = x + run
                    while run >= (1 << _J[run_index]):
                        bw.put(1, 1)
                        run -= 1 << _J[run_index]
                        if run_index < 31:
                            run_index += 1
                    if x_end > w:
                        # terminated by end of line
                        if run > 0:
                            bw.put(1, 1)
                        x = x_end
                        break
                    bw.put(0, 1)
                    if _J[run_index]:
                        bw.put(run, _J[run_index])
                    x = x_end
                    ra = cur[x - 1]
                    rb = prev[x]
                    val = int(src[y, x - 1])
                    rx = _ri_encode(bw, st, val, ra, rb, p, run_index)
                    cur[x] = rx
                    x += 1
                    if run_index > 0:
                        run_index -= 1
                continue

            # ---- regular mode (A.4-A.6) ----
            if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
                sign = -1
                q = -(q1 * 81 + q2 * 9 + q3)
            else:
                sign = 1
                q = q1 * 81 + q2 * 9 + q3
            # med predictor
            if rc >= max(ra, rb):
                px = min(ra, rb)
            elif rc <= min(ra, rb):
                px = max(ra, rb)
            else:
                px = ra + rb - rc
            px += st.C[q] if sign > 0 else -st.C[q]
            px = 0 if px < 0 else (maxval if px > maxval else px)

            k = _k_for(st.N[q], st.A[q])
            special = near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]

            if decode:
                merr = _golomb_decode(br, k, limit, qbpp)
                if special:
                    errval = (merr - 1) // 2 if (merr & 1) else -(merr // 2) - 1
                else:
                    errval = merr // 2 if not (merr & 1) else -((merr + 1) // 2)
                _update_regular(st, q, errval, near, reset)
                if near:
                    errval *= 2 * near + 1
                rx = px + sign * errval
                if rx < -near:
                    rx += rng * (2 * near + 1)
                elif rx > maxval + near:
                    rx -= rng * (2 * near + 1)
                rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
                cur[x] = rx
            else:
                val = int(src[y, x - 1])
                errval = val - px
                if sign < 0:
                    errval = -errval
                if near:
                    if errval > 0:
                        errval = (near + errval) // (2 * near + 1)
                    else:
                        errval = -((near - errval) // (2 * near + 1))
                    rx = px + sign * errval * (2 * near + 1)
                    rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
                else:
                    rx = val
                errval = _mod_range(errval, rng)
                if special:
                    merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
                else:
                    merr = 2 * errval if errval >= 0 else -2 * errval - 1
                _golomb_encode(bw, merr, k, limit, qbpp)
                _update_regular(st, q, errval, near, reset)
                cur[x] = rx
            x += 1

        if decode:
            out[y, :] = cur[1 : w + 1]
        cur[w + 1] = cur[w]
        prev, cur = cur, prev
        prev[w + 1] = prev[w]

    return out


def _ri_params(st, ritype):
    q = 365 + ritype
    temp = st.A[q] + ((st.N[q] >> 1) if ritype else 0)
    k = _k_for(st.N[q], temp)
    return q, k


def _ri_update(st, q, errval, emerr, ritype, reset):
    if errval < 0:
        st.Nn[q - 365] += 1
    st.A[q] += (emerr + 1 - ritype) >> 1
    if st.N[q] == reset:
        st.A[q] >>= 1
        st.N[q] >>= 1
        st.Nn[q - 365] >>= 1
    st.N[q] += 1


def _ri_encode(bw, st, val, ra, rb, p, run_index):
    """A.7.2 run-interruption sample; returns the reconstructed value."""
    near, rng, maxval = p.near, p.range, p.maxval
    ritype = 1 if abs(ra - rb) <= near else 0
    px = ra if ritype else rb
    errval = val - px
    if ritype == 0 and ra > rb:
        errval = -errval
        sgn = -1
    else:
        sgn = 1
    if near:
        if errval > 0:
            errval = (near + errval) // (2 * near + 1)
        else:
            errval = -((near - errval) // (2 * near + 1))
        rx = px + sgn * errval * (2 * near + 1)
        rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
    else:
        rx = val
    errval = _mod_range(errval, rng)
    q, k = _ri_params(st, ritype)
    nn, n = st.Nn[q - 365], st.N[q]
    if k == 0 and errval > 0 and 2 * nn < n:
        m = 1
    elif errval < 0 and 2 * nn >= n and k == 0:
        m = 1
    elif errval < 0 and k != 0:
        m = 1
    else:
        m = 0
    emerr = 2 * abs(errval) - ritype - m
    _golomb_encode(bw, emerr, k, p.limit - _J[run_index] - 1, p.qbpp)
    _ri_update(st, q, errval, emerr, ritype, p.reset)
    return rx


def _ri_decode(br, st, ra, rb, p, run_index):
    near, rng, maxval = p.near, p.range, p.maxval
    ritype = 1 if abs(ra - rb) <= near else 0
    px = ra if ritype else rb
    q, k = _ri_params(st, ritype)
    emerr = _golomb_decode(br, k, p.limit - _J[run_index] - 1, p.qbpp)
    m = (emerr + ritype) & 1
    mag = (emerr + ritype + m) >> 1
    if mag == 0:
        errval = 0
    else:
        positive = (m == 1) == (k == 0 and 2 * st.Nn[q - 365] < st.N[q])
        errval = mag if positive else -mag
    _ri_update(st, q, errval, emerr, ritype, p.reset)
    if near:
        errval *= 2 * near + 1
    sgn = -1 if (ritype == 0 and ra > rb) else 1
    rx = px + sgn * errval
    if rx < -near:
        rx += rng * (2 * near + 1)
    elif rx > maxval + near:
        rx -= rng * (2 * near + 1)
    rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
    return rx


# ---------------------------------------------------------------------------
# stream layer
# ---------------------------------------------------------------------------


def encode(img, near: int = 0, precision: int | None = None) -> bytes:
    """Encode a 2D grayscale image as a JPEG-LS stream (single component,
    no interleave). near=0 is lossless; near>0 bounds |err| by near."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise JlsError("encode: 2D grayscale only")
    if precision is None:
        precision = max(2, int(img.max()).bit_length()) if img.size else 8
    h, w = img.shape
    p = _Params(precision, w, h, near=near)

    out = bytearray()
    out += struct.pack(">BB", 0xFF, SOI)
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0])
    out += struct.pack(">BBH", 0xFF, SOF55, len(sof) + 2) + sof
    sos = bytes([1, 1, 0x00, near, 0, 0])  # Ns=1, comp 1, NEAR, ILV=0, Al=0
    out += struct.pack(">BBH", 0xFF, SOS, len(sos) + 2) + sos

    bw = _JlsBitWriter()
    _codec(img, bw, p, decode=False)
    bw.flush()
    out += bytes(bw.out)
    out += struct.pack(">BB", 0xFF, EOI)
    return bytes(out)


def decode(data: bytes):
    """Decode a JPEG-LS stream. Returns (image [h, w], precision)."""
    data = bytes(data)
    if len(data) < 4 or data[0] != 0xFF or data[1] != SOI:
        raise JlsError("not a JPEG-LS stream (missing SOI)")
    i = 2
    n = len(data)
    precision = height = width = None
    maxval = t1 = t2 = t3 = reset = None
    while i < n:
        while i < n and data[i] == 0xFF:
            i += 1
        m = data[i]
        i += 1
        if m == EOI:
            break
        (seglen,) = struct.unpack_from(">H", data, i)
        seg = data[i + 2 : i + seglen]
        i += seglen
        if m == SOF55:
            precision, height, width, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise JlsError("only single-component JPEG-LS supported")
        elif m == LSE:
            if seg[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack_from(">5H", seg, 1)
        elif m == SOS:
            near = seg[3]
            ilv = seg[4]
            if ilv != 0:
                raise JlsError("interleaved JPEG-LS not supported")
            if precision is None:
                raise JlsError("SOS before SOF55")
            p = _Params(precision, width, height, near=near, maxval=maxval,
                        t1=t1, t2=t2, t3=t3, reset=reset)
            # the native scan decoder (native/jls.cpp); the Python loop, its
            # plain version, decides where the library declines the stream
            out = native.jls_decode_scan_host(
                data[i:], width, height, p.maxval, p.near,
                p.t1, p.t2, p.t3, p.reset, p.qbpp, p.limit,
            )
            if out is None:
                native.count("jls_decode_scan", python=True)
                br = _JlsBitReader(data[i:])
                out = _codec(None, br, p, decode=True)
            dt = np.uint16 if precision > 8 else np.uint8
            return out.astype(dt), precision
    raise JlsError("no scan found in JPEG-LS stream")
