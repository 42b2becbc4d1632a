"""From-scratch JPEG 2000 decoder (ITU-T T.800) for DICOM pixel data.

Closes the last compressed transfer syntaxes the reference hands to the
dcm2niix binary (deepwmh/external_tools/dcm2niix.py:54):
1.2.840.10008.1.2.4.90 (JPEG 2000 Lossless, reversible 5/3 wavelet) and
.91 (JPEG 2000, irreversible 9/7). Scope: raw J2K codestreams and JP2
containers, single tile (any number of tile-parts), arbitrary code-block
sizes and decomposition levels, LRCP/RLCP/RPCL/PCRL/CPRL progressions with
any layer count, every code-block style (selective arithmetic bypass,
per-pass termination, context reset, vertical stripe-causal contexts,
predictable termination, segmentation symbols — the Kakadu-family
defaults included), SOP/EPH markers, per-component COC/QCC overrides,
grayscale and RGB (with the reversible/irreversible component transform),
1-16 bit, signed or unsigned.

Layers (bottom-up, each validated against openjpeg-produced streams via
PIL in tests/test_j2kcodec.py):
  _MQDecoder/_MQEncoder  T.88 arithmetic coder (the encoder exists to
                         round-trip-test the decoder in isolation)
  _TagTree               packet-header inclusion / zero-bitplane trees
  _decode_block          EBCOT Tier-1: significance propagation, magnitude
                         refinement and cleanup passes with the T.800
                         context model
  _parse_codestream      markers (SIZ/COD/QCD/SOT/SOD...), Tier-2 packet
                         headers, code-block segment assembly
  _idwt53 / _idwt97      multilevel inverse lifting on arbitrary grids
  decode()               tiles -> components -> level shift / MCT

Host code: the DICOM import path, not the card's. Tier-1 runs in native
C++ (native/j2k_t1.cpp) for the single-MQ-segment default styles;
_BlockDecoder is its plain version, decodes the other code-block styles
(bypass, termall, reset, VSC) and decides where the library declines a
block.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from deepwmh_tpu_torch import native


class J2kError(ValueError):
    pass


# ---------------------------------------------------------------------------
# MQ arithmetic coder (ITU-T T.88, software conventions of T.800 Annex C)
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH)
_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]


class _MQDecoder:
    """T.88 MQ decoder over one code-block's byte segment."""

    __slots__ = ("data", "bp", "n", "c", "a", "ct", "I", "mps")

    def __init__(self, data: bytes, n_contexts: int = 19):
        self.data = data
        self.n = len(data)
        self.I = [0] * n_contexts
        self.mps = [0] * n_contexts
        # INITDEC
        self.bp = 0
        b0 = data[0] if self.n > 0 else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp, n = self.data, self.bp, self.n
        b = data[bp] if bp < n else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < n else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[self.bp] if self.bp < n else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        qe, nmps, nlps, switch = _QE[self.I[cx]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = self.mps[cx]
                self.I[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                self.I[cx] = nlps
            self.a = qe
            # RENORMD
            while True:
                if self.ct == 0:
                    self._bytein()
                self.a = (self.a << 1) & 0xFFFF
                self.c = (self.c << 1) & 0xFFFFFFFF
                self.ct -= 1
                if self.a & 0x8000:
                    break
            return d
        self.c -= qe << 16
        if (self.a & 0x8000) == 0:
            # MPS exchange path
            if self.a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                self.I[cx] = nlps
            else:
                d = self.mps[cx]
                self.I[cx] = nmps
            while True:
                if self.ct == 0:
                    self._bytein()
                self.a = (self.a << 1) & 0xFFFF
                self.c = (self.c << 1) & 0xFFFFFFFF
                self.ct -= 1
                if self.a & 0x8000:
                    break
            return d
        return self.mps[cx]


class _MQEncoder:
    """T.88 MQ encoder — exists to round-trip-test the decoder without any
    external bitstream (tests also validate against openjpeg streams)."""

    __slots__ = ("out", "c", "a", "ct", "I", "mps")

    def __init__(self, n_contexts: int = 19):
        # out[0] is the T.88 INITENC scratch byte "before" the stream; it
        # absorbs a (never-materializing) first carry and is dropped at
        # flush time
        self.out = bytearray([0])
        self.c = 0
        self.a = 0x8000
        self.ct = 12
        self.I = [0] * n_contexts
        self.mps = [0] * n_contexts

    def _byteout(self):
        # T.88 Figure E.19
        if self.out[-1] == 0xFF:
            # 7 data bits + the carry position (value may reach 0x8F)
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1  # carry into the finished byte
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx: int, d: int):
        qe, nmps, nlps, switch = _QE[self.I[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            # CODEMPS (Figure E.16)
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.I[cx] = nmps
        else:
            # CODELPS (Figure E.17)
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.mps[cx] = 1 - self.mps[cx]
            self.I[cx] = nlps
        while True:  # RENORME
            self.a = (self.a << 1) & 0xFFFF
            self.c = self.c << 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        # SETBITS (Figure E.20) + FLUSH (Figure E.21)
        tempc = self.c + self.a - 1
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        if self.out and self.out[-1] == 0xFF:
            self.out.pop()  # optional trailing-FF discard
        return bytes(self.out[1:])  # drop the INITENC scratch byte


# ---------------------------------------------------------------------------
# Tag trees (T.800 B.10.2)
# ---------------------------------------------------------------------------


class _TagTree:
    """2D tag tree: each level halves the grid (ceil); decode(i, j, thr)
    answers whether leaf value < thr, refining node lower bounds with bits
    from the packet-header reader."""

    def __init__(self, w: int, h: int):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [np.zeros((lh, lw), np.int32) for lw, lh in self.levels]
        self.known = [np.zeros((lh, lw), bool) for lw, lh in self.levels]

    def decode(self, rd, j: int, i: int, threshold: int) -> bool:
        """rd: _PacketBitReader. Returns True if value(leaf) < threshold."""
        # walk root -> leaf
        path = []
        jj, ii = j, i
        for lvl in range(len(self.levels)):
            path.append((lvl, jj, ii))
            jj, ii = jj // 2, ii // 2
        low = 0
        for lvl, jj, ii in reversed(path):
            v = self.value[lvl]
            k = self.known[lvl]
            if v[ii, jj] < low:
                v[ii, jj] = low
            while not k[ii, jj] and v[ii, jj] < threshold:
                if rd.bit():
                    k[ii, jj] = True
                else:
                    v[ii, jj] += 1
            low = v[ii, jj]
            if not k[ii, jj]:
                # threshold reached without resolution: leaf >= threshold
                return False
        return self.value[0][i, j] < threshold

    def leaf_value(self, j: int, i: int) -> int:
        return int(self.value[0][i, j])


class _PacketBitReader:
    """Packet-header bit reader with 0xFF stuffing (a 0 bit follows any
    0xFF byte, B.10.1)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.bits = 0
        self.last = 0

    def _next_byte(self) -> int:
        if self.pos >= len(self.data):
            raise J2kError("packet header past end of data")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bit(self) -> int:
        if self.bits == 0:
            b = self._next_byte()
            if self.last == 0xFF:
                self.buf = b & 0x7F
                self.bits = 7
            else:
                self.buf = b
                self.bits = 8
            self.last = b
        self.bits -= 1
        return (self.buf >> self.bits) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """End of packet header: discard remaining bits; if the final byte
        was 0xFF a stuffing byte follows (B.10.1)."""
        if self.bits == 0 and self.last == 0xFF:
            if self.pos < len(self.data) and self.data[self.pos] == 0x00:
                self.pos += 1
        self.bits = 0
        self.last = 0


# ---------------------------------------------------------------------------
# EBCOT Tier-1 code-block decoder (T.800 Annex D)
# ---------------------------------------------------------------------------

# context numbering (19 contexts): 0-8 zero coding, 9-13 sign, 14-16
# magnitude refinement, 17 run-length, 18 uniform
_CX_RL = 17
_CX_UNI = 18

# zero-coding lookup per orientation, indexed [h][v][d] (counts clamped)
def _zc_tables():
    ll = np.zeros((3, 3, 5), np.int8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                else:
                    if v == 2:
                        c = 4
                    elif v == 1:
                        c = 3
                    else:
                        c = 2 if d >= 2 else (1 if d == 1 else 0)
                ll[h, v, d] = c
    hh = np.zeros((5, 5, 5), np.int8)  # indexed [h][v][d] with h+v<=4
    for h in range(5):
        for v in range(5):
            hv = min(h + v, 4)
            for d in range(5):
                if d >= 3:
                    c = 8
                elif d == 2:
                    c = 7 if hv >= 1 else 6
                elif d == 1:
                    c = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    c = 2 if hv >= 2 else (1 if hv == 1 else 0)
                hh[h, v, d] = c
    return ll, hh


_ZC_LL, _ZC_HH = _zc_tables()

# sign-coding: (hc+1, vc+1) -> (context, xor)
_SC = {
    (2, 2): (13, 0), (2, 1): (12, 0), (2, 0): (11, 0),
    (1, 2): (10, 0), (1, 1): (9, 0), (1, 0): (10, 1),
    (0, 2): (11, 1), (0, 1): (12, 1), (0, 0): (13, 1),
}


def _init_t1_states():
    """Initial (index, mps) per context, T.800 Table D.7."""
    I = [0] * 19
    mps = [0] * 19
    I[0] = 4       # zero coding context 0
    I[_CX_RL] = 3  # run-length
    I[_CX_UNI] = 46
    return I, mps


class _RawBitReader(_PacketBitReader):
    """Raw (bypass) codeword-segment bit reader (D.7). Identical MSB-first
    bit-unstuffing to the packet-header reader (a byte following 0xFF
    carries only 7 bits); the one semantic difference is end-of-data —
    exhausted raw segments pad with 0xFF instead of raising (a terminated
    segment may end mid-stripe; the spec's marker-range fill)."""

    def _next_byte(self) -> int:
        if self.pos >= len(self.data):
            self.pos += 1
            return 0xFF
        b = self.data[self.pos]
        self.pos += 1
        return b


class _BlockDecoder:
    """Decode one code-block's coding passes into magnitude + sign.

    vsc: vertical stripe-causal contexts (style bit 0x08) — for samples in
    a stripe's last row, the row below (the next stripe) is treated as
    insignificant during context formation."""

    def __init__(self, w: int, h: int, orientation: int, vsc: bool = False):
        self.w, self.h = w, h
        self.orient = orientation  # 0 LL, 1 HL, 2 LH, 3 HH
        self.vsc = vsc
        self.sig = np.zeros((h + 2, w + 2), np.uint8)   # 1-padded borders
        self.sgn = np.zeros((h + 2, w + 2), np.uint8)   # 1 = negative
        self.visited = np.zeros((h + 2, w + 2), np.uint8)
        self.refined = np.zeros((h + 2, w + 2), np.uint8)
        self.mag = np.zeros((h, w), np.int64)

    def _stripe_causal(self, y):
        return self.vsc and (y - 1) % 4 == 3

    def _zc_ctx(self, y, x):
        s = self.sig
        below = 0 if self._stripe_causal(y) else 1
        h = int(s[y, x - 1]) + int(s[y, x + 1])
        v = int(s[y - 1, x]) + below * int(s[y + 1, x])
        d = (int(s[y - 1, x - 1]) + int(s[y - 1, x + 1])
             + below * (int(s[y + 1, x - 1]) + int(s[y + 1, x + 1])))
        o = self.orient
        if o == 0 or o == 2:  # LL, LH
            return int(_ZC_LL[h, v, min(d, 4)])
        if o == 1:  # HL: transpose h/v
            return int(_ZC_LL[v, h, min(d, 4)])
        return int(_ZC_HH[h, v, min(d, 4)])

    def _sc_decode(self, mq, y, x):
        s, g = self.sig, self.sgn
        below = 0 if self._stripe_causal(y) else 1

        def contrib(a, b, wb=1):
            sa = int(s[a]) * (1 - 2 * int(g[a]))
            sb = wb * int(s[b]) * (1 - 2 * int(g[b]))
            return max(-1, min(1, sa + sb))

        hc = contrib((y, x - 1), (y, x + 1))
        vc = contrib((y - 1, x), (y + 1, x), below)
        ctx, xor = _SC[(hc + 1, vc + 1)]
        return mq.decode(ctx) ^ xor

    def sig_pass(self, mq, plane, raw=False):
        w, h = self.w, self.h
        sig, vis = self.sig, self.visited
        for y0 in range(1, h + 1, 4):
            for x in range(1, w + 1):
                for y in range(y0, min(y0 + 4, h + 1)):
                    if sig[y, x]:
                        continue
                    ctx = self._zc_ctx(y, x)
                    if ctx == 0:
                        continue  # no significant neighbors
                    vis[y, x] = 1
                    if raw:
                        if mq.bit():
                            # raw sign: one bit, no context/xor (D.7)
                            sig[y, x] = 1
                            self.sgn[y, x] = mq.bit()
                            self.mag[y - 1, x - 1] = 1 << plane
                    elif mq.decode(ctx):
                        neg = self._sc_decode(mq, y, x)
                        sig[y, x] = 1
                        self.sgn[y, x] = neg
                        self.mag[y - 1, x - 1] = 1 << plane

    def mag_pass(self, mq, plane, raw=False):
        w, h = self.w, self.h
        sig, vis, ref = self.sig, self.visited, self.refined
        s = sig
        for y0 in range(1, h + 1, 4):
            for x in range(1, w + 1):
                for y in range(y0, min(y0 + 4, h + 1)):
                    if not sig[y, x] or vis[y, x]:
                        continue
                    if raw:
                        ref[y, x] = 1
                        bit = mq.bit()
                    else:
                        if ref[y, x]:
                            ctx = 16
                        else:
                            below = 0 if self._stripe_causal(y) else 1
                            nbr = (int(s[y, x-1]) + int(s[y, x+1])
                                   + int(s[y-1, x]) + below * int(s[y+1, x])
                                   + int(s[y-1, x-1]) + int(s[y-1, x+1])
                                   + below * (int(s[y+1, x-1])
                                              + int(s[y+1, x+1])))
                            ctx = 15 if nbr else 14
                            ref[y, x] = 1
                        bit = mq.decode(ctx)
                    self.mag[y - 1, x - 1] |= bit << plane
                    vis[y, x] = 1

    def cleanup_pass(self, mq, plane, segsym=False):
        w, h = self.w, self.h
        sig, vis = self.sig, self.visited
        for y0 in range(1, h + 1, 4):
            full = y0 + 3 <= h
            for x in range(1, w + 1):
                y = y0
                if full:
                    # run-length mode: all 4 unvisited, insignificant, with
                    # entirely insignificant neighborhoods
                    rl = True
                    for yy in range(y0, y0 + 4):
                        if sig[yy, x] or vis[yy, x] or self._zc_ctx(yy, x) != 0:
                            rl = False
                            break
                    if rl:
                        if mq.decode(_CX_RL) == 0:
                            for yy in range(y0, y0 + 4):
                                vis[yy, x] = 0
                            continue
                        r = (mq.decode(_CX_UNI) << 1) | mq.decode(_CX_UNI)
                        y = y0 + r
                        # the r-th sample is significant (its ZC bit implied)
                        neg = self._sc_decode(mq, y, x)
                        sig[y, x] = 1
                        self.sgn[y, x] = neg
                        self.mag[y - 1, x - 1] = 1 << plane
                        y += 1
                for yy in range(y, min(y0 + 4, h + 1)):
                    if vis[yy, x]:
                        vis[yy, x] = 0
                        continue
                    if sig[yy, x]:
                        vis[yy, x] = 0
                        continue
                    if mq.decode(self._zc_ctx(yy, x)):
                        neg = self._sc_decode(mq, yy, x)
                        sig[yy, x] = 1
                        self.sgn[yy, x] = neg
                        self.mag[yy - 1, x - 1] = 1 << plane
        # clear visited for next bit-plane
        self.visited[:] = 0
        self.refined_sticky()
        if segsym:
            s = (mq.decode(_CX_UNI) << 3) | (mq.decode(_CX_UNI) << 2) | \
                (mq.decode(_CX_UNI) << 1) | mq.decode(_CX_UNI)
            if s != 0x0A:
                raise J2kError("segmentation symbol mismatch")

    def refined_sticky(self):
        pass  # refined[] persists across planes by design

    def decode_passes(self, data: bytes, n_passes: int, msb_plane: int,
                      segsym: bool = False):
        """Run n_passes from one un-segmented codeword (style bits other
        than the segmentation symbol all zero)."""
        seg = _Segment(False)
        seg.data = bytearray(data)
        seg.passes = n_passes
        self.decode_segments([seg], msb_plane, 0x20 if segsym else 0)

    def decode_segments(self, segments, msb_plane: int, style: int):
        """Run the coding passes of ordered codeword segments. MQ context
        states persist across MQ segments (each gets a fresh arithmetic
        coder on its own bytes); RESET (0x02) reinitializes the states at
        every pass boundary; raw segments use the bypass bit reader."""
        segsym = bool(style & 0x20)
        I, mps = _init_t1_states()
        plane = msb_plane
        kind = 2  # 0 = sig, 1 = mag, 2 = cleanup; first pass is cleanup
        for seg in segments:
            if seg.raw:
                dec = _RawBitReader(bytes(seg.data))
            else:
                dec = _MQDecoder(bytes(seg.data), 19)
                dec.I, dec.mps = I, mps  # shared, persistent states
            for _ in range(seg.passes):
                if plane < 0:
                    raise J2kError("more passes than bit-planes")
                if style & 0x02:  # RESET: fresh contexts each pass
                    ni, nm = _init_t1_states()
                    I[:] = ni
                    mps[:] = nm
                if kind == 0:
                    self.sig_pass(dec, plane, raw=seg.raw)
                elif kind == 1:
                    self.mag_pass(dec, plane, raw=seg.raw)
                else:
                    if seg.raw:
                        raise J2kError("cleanup pass in a raw segment")
                    self.cleanup_pass(dec, plane, segsym=segsym)
                if kind == 2:
                    plane -= 1
                    kind = 0
                else:
                    kind += 1

    def values(self):
        neg = self.sgn[1:-1, 1:-1].astype(bool)
        v = self.mag.copy()
        v[neg] = -v[neg]
        return v


# ---------------------------------------------------------------------------
# Inverse DWT (T.800 Annex F) — whole-image tile at origin (0,0)
# ---------------------------------------------------------------------------


def _sr1d_53(low, high):
    """1D reversible 5/3 synthesis: interleave low (even) / high (odd) and
    undo the lifting steps. Arrays are 1D int64; returns len(low)+len(high)."""
    n = len(low) + len(high)
    x = np.zeros(n, np.int64)
    if n == 1:
        x[0] = low[0] if len(low) else high[0] >> 1
        return x
    x[0::2] = low
    x[1::2] = high
    # even: x[2n] -= floor((x[2n-1] + x[2n+1] + 2) / 4), symmetric extension
    xo = x[1::2]
    left = np.empty(len(low), np.int64)
    left[0] = xo[0] if len(xo) else 0          # x[-1] mirrors x[1]
    left[1:] = xo[: len(low) - 1]
    right = np.empty(len(low), np.int64)
    m = min(len(xo), len(low))
    right[:m] = xo[:m]
    if len(low) > len(xo):                     # x[n] mirrors x[n-2] (odd tail)
        right[-1] = xo[-1]
    x[0::2] = low - ((left + right + 2) >> 2)
    # odd: x[2n+1] += floor((x[2n] + x[2n+2]) / 2)
    xe = x[0::2]
    left = xe[: len(high)]
    right = np.empty(len(high), np.int64)
    m = min(len(high), len(xe) - 1)
    right[:m] = xe[1 : m + 1]
    if len(high) > m:                          # mirror at the right edge
        right[m:] = xe[-1]
    x[1::2] = high + ((left + right) >> 1)
    return x


_K97 = 1.230174104914001
_D97 = [
    (-1.586134342059924, 1),  # (coefficient, applies to odd) analysis order
    (-0.052980118572961, 0),
    (0.882911075530934, 1),
    (0.443506852043971, 0),
]


def _sr1d_97(low, high):
    n = len(low) + len(high)
    x = np.zeros(n, np.float64)
    if n == 1:
        x[0] = low[0] if len(low) else high[0]
        return x
    x[0::2] = low * _K97
    x[1::2] = high / _K97
    # undo lifting in reverse
    for coef, on_odd in reversed(_D97):
        if on_odd:
            xe = x[0::2]
            left = xe[: len(high)]
            right = np.empty(len(high))
            m = min(len(high), len(xe) - 1)
            right[:m] = xe[1 : m + 1]
            if len(high) > m:
                right[m:] = xe[-1]
            x[1::2] -= coef * (left + right)
        else:
            xo = x[1::2]
            left = np.empty(len(low))
            left[0] = xo[0] if len(xo) else 0
            left[1:] = xo[: len(low) - 1]
            right = np.empty(len(low))
            m = min(len(xo), len(low))
            right[:m] = xo[:m]
            if len(low) > len(xo):
                right[-1] = xo[-1]
            x[0::2] -= coef * (left + right)
    return x


def _idwt2(ll, bands, reversible: bool):
    """One synthesis level: ll [h0,w0] + (hl, lh, hh) -> next resolution.

    Horizontal synthesis first, then vertical — the inverse of the
    analysis order; with integer (floor) lifting the two orders do NOT
    commute, and the wrong order leaves +-few-code-value errors (verified
    exact against openjpeg only in this order)."""
    hl, lh, hh = bands
    h0, w0 = ll.shape
    h1, w1 = hh.shape[0], hh.shape[1]
    H, W = h0 + h1, w0 + w1
    f = _sr1d_53 if reversible else _sr1d_97
    dt = np.int64 if reversible else np.float64
    top = np.zeros((h0, W), dt)  # rows of (ll | hl)
    for i in range(h0):
        top[i, :] = f(ll[i, :].astype(dt), hl[i, :].astype(dt))
    bot = np.zeros((h1, W), dt)  # rows of (lh | hh)
    for i in range(h1):
        bot[i, :] = f(lh[i, :].astype(dt), hh[i, :].astype(dt))
    out = np.zeros((H, W), dt)
    for j in range(W):
        out[:, j] = f(top[:, j], bot[:, j])
    return out


# ---------------------------------------------------------------------------
# Codestream parsing + Tier-2 packet decoding
# ---------------------------------------------------------------------------

_SOC, _SIZ, _COD, _COC = 0xFF4F, 0xFF51, 0xFF52, 0xFF53
_QCD, _QCC, _COM, _SOT = 0xFF5C, 0xFF5D, 0xFF64, 0xFF90
_SOD, _EOC, _SOP, _EPH = 0xFF93, 0xFFD9, 0xFF91, 0xFF92
_TLM, _PLM, _PLT, _POC, _RGN, _CRG = 0xFF55, 0xFF57, 0xFF58, 0xFF5F, 0xFF5E, 0xFF63


class _Cod:
    __slots__ = ("prog", "layers", "mct", "levels", "cbw", "cbh", "style",
                 "wavelet", "precw", "prech", "use_sop", "use_eph")


def _parse_cod(seg):
    c = _Cod()
    scod = seg[0]
    c.prog = seg[1]
    c.layers = struct.unpack_from(">H", seg, 2)[0]
    c.mct = seg[4]
    c.levels = seg[5]
    c.cbw = 1 << ((seg[6] & 15) + 2)
    c.cbh = 1 << ((seg[7] & 15) + 2)
    c.style = seg[8]
    c.wavelet = seg[9]  # 0 = 9/7 irreversible, 1 = 5/3 reversible
    if scod & 1:  # user precincts
        c.precw = [(seg[10 + i] & 15) for i in range(c.levels + 1)]
        c.prech = [(seg[10 + i] >> 4) for i in range(c.levels + 1)]
    else:
        c.precw = [15] * (c.levels + 1)
        c.prech = [15] * (c.levels + 1)
    c.use_sop = bool(scod & 0x02)
    c.use_eph = bool(scod & 0x04)
    return c


def _parse_coc(seg, ncomp):
    """COC: per-component coding-style override (A.6.2). Returns
    (comp_index, partial _Cod with the COD-shared fields left None)."""
    if ncomp < 257:
        comp, off = seg[0], 1
    else:
        comp, off = struct.unpack_from(">H", seg, 0)[0], 2
    scoc = seg[off]
    c = _Cod()
    c.prog = c.layers = c.mct = None  # tile-level (COD only)
    c.use_sop = c.use_eph = None
    c.levels = seg[off + 1]
    c.cbw = 1 << ((seg[off + 2] & 15) + 2)
    c.cbh = 1 << ((seg[off + 3] & 15) + 2)
    c.style = seg[off + 4]
    c.wavelet = seg[off + 5]
    if scoc & 1:
        c.precw = [(seg[off + 6 + i] & 15) for i in range(c.levels + 1)]
        c.prech = [(seg[off + 6 + i] >> 4) for i in range(c.levels + 1)]
    else:
        c.precw = [15] * (c.levels + 1)
        c.prech = [15] * (c.levels + 1)
    return comp, c


def _parse_qcc(seg, ncomp):
    """QCC: per-component quantization override. Returns (comp_index,
    SQcd-format bytes)."""
    if ncomp < 257:
        return seg[0], seg[1:]
    return struct.unpack_from(">H", seg, 0)[0], seg[2:]


def _parse_qcd(seg, levels):
    sqcd = seg[0]
    guard = sqcd >> 5
    style = sqcd & 0x1F
    n_bands = 3 * levels + 1
    if style == 0:  # no quantization: 8-bit exponents
        exps = [seg[1 + i] >> 3 for i in range(n_bands)]
        mants = [0] * n_bands
    elif style == 1:  # scalar derived: one value
        e, = struct.unpack_from(">H", seg, 1)
        exps, mants = [e >> 11], [e & 0x7FF]
    elif style == 2:  # scalar expounded
        exps, mants = [], []
        for i in range(n_bands):
            e, = struct.unpack_from(">H", seg, 1 + 2 * i)
            exps.append(e >> 11)
            mants.append(e & 0x7FF)
    else:
        raise J2kError("unknown quantization style %d" % style)
    return guard, style, exps, mants


class _Segment:
    """One terminated codeword segment of a code-block (B.10.7): its own
    byte range, decoded with its own MQ or raw coder instance."""

    __slots__ = ("raw", "data", "passes")

    def __init__(self, raw: bool):
        self.raw = raw
        self.data = bytearray()
        self.passes = 0


def _seg_index(p, style):
    """Codeword-segment index containing global coding pass p (0-based;
    pass 0 is the first cleanup) for the given code-block style."""
    if style & 0x04:  # termall: every pass its own segment
        return p
    if style & 0x01:  # selective bypass: MQ for the first 10 passes (the
        # 4 most significant bit-planes), then alternating raw(sig+mag) /
        # MQ(cleanup) segments
        if p < 10:
            return 0
        q, r = divmod(p - 10, 3)
        return 1 + 2 * q + (0 if r < 2 else 1)
    return 0


def _seg_is_raw(p, style):
    """Is the segment containing pass p raw-coded (bypass)?"""
    if not style & 0x01:
        return False
    return p >= 10 and (p - 10) % 3 < 2


def _segment_plan(p0, n, style):
    """Split the n new passes starting at global pass p0 into per-segment
    contributions [(seg_idx, first_pass, n_passes)] — one signalled length
    each (B.10.7.1)."""
    if not style & 0x05:
        return [(0, p0, n)]
    out = []
    p = p0
    while n > 0:
        if style & 0x04:
            out.append((p, p, 1))
            p += 1
            n -= 1
            continue
        if p < 10:
            k = min(n, 10 - p)
        else:
            r = (p - 10) % 3
            k = min(n, (2 - r) if r < 2 else 1)
        out.append((_seg_index(p, style), p, k))
        p += k
        n -= k
    return out


class _Block:
    __slots__ = ("x0", "y0", "w", "h", "included", "msbs", "lblock",
                 "passes", "segments", "band")

    def __init__(self, x0, y0, w, h, band):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h
        self.included = False
        self.msbs = 0
        self.lblock = 3
        self.passes = 0
        self.segments = {}  # seg_idx -> _Segment
        self.band = band

    def segment(self, idx, raw):
        if idx not in self.segments:
            self.segments[idx] = _Segment(raw)
        return self.segments[idx]


class _Band:
    __slots__ = ("orient", "x0", "y0", "w", "h", "blocks", "nbx", "nby",
                 "incl_tree", "msb_tree", "exp", "mant")


def _npasses_decode(rd):
    if rd.bit() == 0:
        return 1
    if rd.bit() == 0:
        return 2
    v = rd.read(2)
    if v < 3:
        return 3 + v
    v = rd.read(5)
    if v < 31:
        return 6 + v
    return 37 + rd.read(7)


def _band_geometry(W, H, levels):
    """Subband rectangles for a (0,0)-origin image: returns per resolution
    the list of bands [(orient, w, h)] — resolution 0 is the LL band."""
    dims = [(W, H)]
    w, h = W, H
    for _ in range(levels):
        w, h = (w + 1) // 2, (h + 1) // 2
        dims.append((w, h))
    # dims[k] = size at decomposition level k; resolution r uses level L-r
    out = []
    L = levels
    llw, llh = dims[L]
    out.append([(0, llw, llh)])
    for r in range(1, L + 1):
        lev = L - r + 1  # bands produced by this decomposition level
        pw, ph = dims[lev - 1]   # parent (finer) size
        lw, lh = dims[lev]       # low size
        hw, hh = pw - lw, ph - lh
        out.append([(1, hw, lh), (2, lw, hh), (3, hw, hh)])
    return out


def _parse_markers(data: bytes):
    """Walk the main + tile headers; returns (siz, cod, qcd, body, cocs,
    qccs) where body is the concatenated entropy-coded data of every
    tile-part (packets continue byte-contiguously across tile-part
    boundaries, A.4.2) and cocs/qccs are the raw per-component override
    segments (parsed later, once SIZ's component count is known)."""
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != _SOC:
        raise J2kError("not a JPEG 2000 codestream (missing SOC)")
    i = 2
    siz = cod = qcd = None
    bodies = []
    cocs, qccs = [], []
    n = len(data)
    sot_start = None
    psot = 0
    expect_tpsot = 0
    while i + 2 <= n:
        m = struct.unpack_from(">H", data, i)[0]
        i += 2
        if m == _EOC:
            break
        if m == _SOD:
            # tile-part body length comes from SOT's Psot (0 = to EOC);
            # trusting "everything to EOC" would silently swallow a later
            # tile-part's marker bytes as packet data
            if psot:
                end = sot_start + psot
                if end > n:
                    raise J2kError("SOT Psot extends past end of stream")
            else:
                end = n
                if n >= 2 and struct.unpack_from(">H", data, n - 2)[0] == _EOC:
                    end = n - 2
            bodies.append(data[i:end])
            i = end
            continue
        seglen = struct.unpack_from(">H", data, i)[0]
        seg = data[i + 2 : i + seglen]
        i += seglen
        if m == _SIZ:
            siz = seg
        elif m == _COD:
            cod = _parse_cod(seg)
        elif m == _QCD:
            qcd = seg
        elif m == _COC:
            cocs.append(seg)
        elif m == _QCC:
            qccs.append(seg)
        elif m == _POC:
            raise J2kError("POC progression changes not supported")
        elif m == _SOT:
            sot_start = i - seglen - 2  # the FF90 marker position
            isot, psot, tpsot, _tnsot = struct.unpack_from(">HIBB", seg, 0)
            if isot != 0:
                raise J2kError("multiple tiles not supported")
            if tpsot != expect_tpsot:
                raise J2kError(
                    "tile-parts out of order (TPsot %d, expected %d)"
                    % (tpsot, expect_tpsot)
                )
            expect_tpsot += 1
        elif m in (_COM, _TLM, _PLM, _PLT, _RGN, _CRG):
            pass
        # unknown markers with lengths are skipped by construction
    if siz is None or cod is None or qcd is None or not bodies:
        raise J2kError("incomplete codestream (need SIZ/COD/QCD/SOD)")
    return siz, cod, qcd, b"".join(bodies), cocs, qccs


def _decode_codestream(data: bytes):
    siz, cod, qcd, body, cocs, qccs = _parse_markers(data)
    _rsiz, W, H, x0, y0, tw, th, tx0, ty0, ncomp = struct.unpack_from(
        ">HIIIIIIIIH", siz, 0
    )
    if x0 or y0 or tx0 or ty0 or tw < W or th < H:
        raise J2kError("tiled or offset-origin codestreams not supported")
    comps = []
    for c in range(ncomp):
        ssiz, xr, yr = struct.unpack_from(">BBB", siz, 36 + 3 * c)
        if xr != 1 or yr != 1:
            raise J2kError("subsampled components not supported")
        comps.append(((ssiz & 0x7F) + 1, bool(ssiz & 0x80)))  # (prec, signed)

    # per-component coding/quantization (COC/QCC overrides)
    comp_cod = [cod] * ncomp
    for seg in cocs:
        ci, c = _parse_coc(seg, ncomp)
        if ci >= ncomp:
            raise J2kError("COC for component %d of %d" % (ci, ncomp))
        comp_cod[ci] = c
    comp_qcd = [qcd] * ncomp
    for seg in qccs:
        ci, q = _parse_qcc(seg, ncomp)
        if ci >= ncomp:
            raise J2kError("QCC for component %d of %d" % (ci, ncomp))
        comp_qcd[ci] = q

    L = cod.levels
    for c in range(ncomp):
        cc = comp_cod[c]
        if cc.levels != L:
            raise J2kError(
                "per-component resolution counts differ (COC levels %d vs "
                "COD %d)" % (cc.levels, L)
            )
        if any(p != 15 for p in cc.precw) or any(p != 15 for p in cc.prech):
            raise J2kError("non-default precincts not supported")
        if cc.style & ~0x3F:
            raise J2kError("code-block style 0x%02x not supported" % cc.style)

    qinfo = [_parse_qcd(comp_qcd[c], L) for c in range(ncomp)]

    geom = _band_geometry(W, H, L)

    # build per component x resolution band/block structures
    structs = []
    for c in range(ncomp):
        cc = comp_cod[c]
        _guard, qstyle, exps, mants = qinfo[c]
        res = []
        for r in range(L + 1):
            bands = []
            for bi, (orient, bw, bh) in enumerate(geom[r]):
                b = _Band()
                b.orient = orient
                b.w, b.h = bw, bh
                band_index = 0 if r == 0 else 1 + 3 * (r - 1) + bi
                if qstyle == 1:  # scalar derived from the LL value
                    lev = L - r + 1 if r > 0 else L
                    b.exp = exps[0] - L + lev
                    b.mant = mants[0]
                else:
                    b.exp = exps[band_index]
                    b.mant = mants[band_index]
                b.nbx = max(0, -(-bw // cc.cbw))
                b.nby = max(0, -(-bh // cc.cbh))
                b.blocks = {}
                if b.nbx and b.nby:
                    b.incl_tree = _TagTree(b.nbx, b.nby)
                    b.msb_tree = _TagTree(b.nbx, b.nby)
                for by in range(b.nby):
                    for bx in range(b.nbx):
                        cx0 = bx * cc.cbw
                        cy0 = by * cc.cbh
                        b.blocks[(bx, by)] = _Block(
                            cx0, cy0,
                            min(cc.cbw, bw - cx0), min(cc.cbh, bh - cy0), b
                        )
                bands.append(b)
            res.append(bands)
        structs.append(res)

    # ---- Tier-2: walk packets in progression order ----
    rd = _PacketBitReader(body)

    def one_packet(c, r, layer):
        style = comp_cod[c].style
        if cod.use_sop:
            # SOP is optional per packet even when flagged (A.8.1)
            if body[rd.pos : rd.pos + 2] == b"\xff\x91":
                rd.pos += 6  # FF91 + Lsop(=0004) + Nsop
        if rd.bit() == 0:  # empty packet
            rd.align()
            if cod.use_eph and body[rd.pos : rd.pos + 2] == b"\xff\x92":
                rd.pos += 2
            return []
        order = []
        for band in structs[c][r]:
            if band.w == 0 or band.h == 0 or not band.blocks:
                continue
            for by in range(band.nby):
                for bx in range(band.nbx):
                    blk = band.blocks[(bx, by)]
                    if not blk.included:
                        inc = band.incl_tree.decode(rd, bx, by, layer + 1)
                    else:
                        inc = rd.bit() == 1
                    if not inc:
                        continue
                    if not blk.included:
                        k = 1
                        while not band.msb_tree.decode(rd, bx, by, k):
                            k += 1
                        blk.msbs = k - 1
                        blk.included = True
                        blk.lblock = 3
                    np_new = _npasses_decode(rd)
                    while rd.bit():
                        blk.lblock += 1
                    # one signalled length per codeword-segment
                    # contribution (B.10.7.1; trivially one when neither
                    # bypass nor termall splits the codeword)
                    contribs = []
                    for seg_idx, p_first, k in _segment_plan(
                        blk.passes, np_new, style
                    ):
                        nbits = blk.lblock + int(math.floor(math.log2(k)))
                        nbytes = rd.read(nbits)
                        contribs.append((seg_idx, p_first, k, nbytes))
                    blk.passes += np_new
                    order.append((blk, style, contribs))
        rd.align()
        if cod.use_eph and body[rd.pos : rd.pos + 2] == b"\xff\x92":
            rd.pos += 2
        for blk, style, contribs in order:
            for seg_idx, p_first, k, nbytes in contribs:
                seg = blk.segment(seg_idx, _seg_is_raw(p_first, style))
                seg.data += body[rd.pos : rd.pos + nbytes]
                seg.passes += k
                rd.pos += nbytes
        return order

    prog = cod.prog
    if prog == 0:  # LRCP
        for layer in range(cod.layers):
            for r in range(L + 1):
                for c in range(ncomp):
                    one_packet(c, r, layer)
    elif prog == 1:  # RLCP
        for r in range(L + 1):
            for layer in range(cod.layers):
                for c in range(ncomp):
                    one_packet(c, r, layer)
    elif prog == 2:  # RPCL (single precinct)
        for r in range(L + 1):
            for c in range(ncomp):
                for layer in range(cod.layers):
                    one_packet(c, r, layer)
    elif prog in (3, 4):  # PCRL / CPRL (single precinct)
        for c in range(ncomp):
            for r in range(L + 1):
                for layer in range(cod.layers):
                    one_packet(c, r, layer)
    else:
        raise J2kError("unknown progression order %d" % prog)

    # ---- Tier-1 + dequant + IDWT per component ----
    out_comps = []
    for c in range(ncomp):
        prec, signed = comps[c]
        style = comp_cod[c].style
        segsym = bool(style & 0x20)
        reversible = comp_cod[c].wavelet == 1
        # guard bits are per-component (a QCC may override the QCD's):
        # M_b = G + eps_b - 1 must use THIS component's G (T.800 E.1)
        guard = qinfo[c][0]
        planes = {}
        for r in range(L + 1):
            for band in structs[c][r]:
                if band.w == 0 or band.h == 0:
                    planes[(r, band.orient)] = np.zeros(
                        (band.h, band.w), np.float64
                    )
                    continue
                gain = {0: 0, 1: 1, 2: 1, 3: 2}[band.orient]
                mb = guard + band.exp - 1
                coeffs = np.zeros((band.h, band.w), np.int64)
                for (bx, by), blk in band.blocks.items():
                    if blk.passes == 0:
                        continue
                    msb_plane = mb - 1 - blk.msbs
                    segs = [blk.segments[i] for i in sorted(blk.segments)]
                    vals = None
                    # native Tier-1 (native/j2k_t1.cpp) handles only the
                    # single-MQ-segment default styles; bypass/termall/
                    # reset/VSC decode in Python
                    if (
                        style & ~0x20 == 0
                        and len(segs) == 1
                        and not segs[0].raw
                    ):
                        vals = native.j2k_decode_block_host(
                            bytes(segs[0].data), blk.w, blk.h,
                            band.orient, blk.passes, msb_plane, segsym,
                        )
                    if vals is None:
                        native.count("j2k_decode_block", python=True)
                        dec = _BlockDecoder(
                            blk.w, blk.h, band.orient,
                            vsc=bool(style & 0x08),
                        )
                        dec.decode_segments(segs, msb_plane, style)
                        vals = dec.values()
                    coeffs[
                        blk.y0 : blk.y0 + blk.h, blk.x0 : blk.x0 + blk.w
                    ] = vals
                if reversible:
                    planes[(r, band.orient)] = coeffs
                else:
                    rb = prec + gain
                    delta = (2.0 ** (rb - band.exp)) * (
                        1.0 + band.mant / 2048.0
                    )
                    planes[(r, band.orient)] = coeffs.astype(np.float64) * delta
        img = planes[(0, 0)]
        for r in range(1, L + 1):
            img = _idwt2(
                img,
                (planes[(r, 1)], planes[(r, 2)], planes[(r, 3)]),
                reversible,
            )
        out_comps.append(img)

    # ---- multiple component transform + level shift ----
    mct_reversible = cod.wavelet == 1  # tile-level choice governs MCT kind
    if cod.mct and ncomp >= 3:
        for c in range(3):
            if (comp_cod[c].wavelet == 1) != mct_reversible:
                # mixing the RCT integer inverse with float components (or
                # vice versa) is non-conformant; fail as a decode error
                # rather than a TypeError deep in numpy
                raise J2kError(
                    "MCT with mismatched per-component wavelets"
                )
        y, u, v = out_comps[0], out_comps[1], out_comps[2]
        if mct_reversible:  # RCT inverse
            g = y - ((u + v) >> 2)
            r_ = v + g
            b_ = u + g
        else:  # ICT inverse
            g = y - 0.34413 * u - 0.71414 * v
            r_ = y + 1.402 * v
            b_ = y + 1.772 * u
        out_comps[0], out_comps[1], out_comps[2] = r_, g, b_

    final = []
    for c in range(ncomp):
        prec, signed = comps[c]
        a = out_comps[c]
        if comp_cod[c].wavelet != 1:
            a = np.round(a)
        a = a.astype(np.int64)
        if not signed:
            a = a + (1 << (prec - 1))
            a = np.clip(a, 0, (1 << prec) - 1)
        else:
            a = np.clip(a, -(1 << (prec - 1)), (1 << (prec - 1)) - 1)
        dt = np.uint8 if prec <= 8 and not signed else (
            np.int16 if signed else np.uint16
        )
        final.append(a.astype(dt))
    if ncomp == 1:
        return final[0], comps[0][0]
    return np.stack(final, -1), comps[0][0]


def decode(data: bytes):
    """Decode a raw J2K codestream or JP2 file. Returns (image, precision):
    [rows, cols] for grayscale, [rows, cols, ncomp] otherwise."""
    data = bytes(data)
    if len(data) >= 12 and data[4:8] == b"jP  ":
        # JP2 container: find the contiguous codestream box
        i = 0
        n = len(data)
        while i + 8 <= n:
            (boxlen,) = struct.unpack_from(">I", data, i)
            btype = data[i + 4 : i + 8]
            hdr = 8
            if boxlen == 1:
                (boxlen,) = struct.unpack_from(">Q", data, i + 8)
                hdr = 16
            elif boxlen == 0:
                boxlen = n - i
            if btype == b"jp2c":
                return _decode_codestream(data[i + hdr : i + boxlen])
            i += boxlen
        raise J2kError("JP2 container has no codestream box")
    return _decode_codestream(data)
