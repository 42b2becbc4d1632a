// Native EBCOT Tier-1 code-block decoder for the JPEG 2000 path
// (core/j2kcodec.py) — MQ decoding plus the three coding passes, ~100x the
// Python loop. Mirrors j2kcodec._BlockDecoder exactly; the Python test
// suite asserts bit-identical output between the two implementations.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };
const QeRow kQe[47] = {
    {0x5601, 1, 1, 1},  {0x3401, 2, 6, 0},  {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0}, {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},  {0x5401, 8, 14, 0}, {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0},{0x3001, 11, 17, 0},{0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0},{0x1601, 29, 21, 0},{0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0},{0x5101, 17, 15, 0},{0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0},{0x3401, 20, 18, 0},{0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0},{0x2401, 23, 20, 0},{0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0},{0x1801, 26, 23, 0},{0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0},{0x1201, 29, 26, 0},{0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0},{0x09C1, 32, 29, 0},{0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0},{0x0441, 35, 32, 0},{0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0},{0x0141, 38, 35, 0},{0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0},{0x0049, 41, 38, 0},{0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0},{0x0009, 44, 41, 0},{0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0},{0x5601, 46, 46, 0},
};

const int CX_RL = 17, CX_UNI = 18;

struct MQ {
    const uint8_t* data;
    int64_t bp, n;
    uint32_t c;
    uint32_t a;
    int ct;
    uint8_t I[19], mps[19];

    void bytein() {
        uint8_t b = bp < n ? data[bp] : 0xFF;
        if (b == 0xFF) {
            uint8_t b1 = bp + 1 < n ? data[bp + 1] : 0xFF;
            if (b1 > 0x8F) { c += 0xFF00; ct = 8; }
            else { bp += 1; c += (uint32_t)b1 << 9; ct = 7; }
        } else {
            bp += 1;
            uint8_t b1 = bp < n ? data[bp] : 0xFF;
            c += (uint32_t)b1 << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* d, int64_t len) {
        data = d; n = len; bp = 0;
        uint8_t b0 = n > 0 ? d[0] : 0xFF;
        c = (uint32_t)b0 << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
        memset(I, 0, sizeof(I));
        memset(mps, 0, sizeof(mps));
        I[0] = 4; I[CX_RL] = 3; I[CX_UNI] = 46;  // T.800 Table D.7
    }
    int decode(int cx) {
        const QeRow& q = kQe[I[cx]];
        uint32_t qe = q.qe;
        a -= qe;
        int d;
        if (((c >> 16) & 0xFFFF) < qe) {
            if (a < qe) { d = mps[cx]; I[cx] = q.nmps; }
            else {
                d = 1 - mps[cx];
                if (q.sw) mps[cx] = 1 - mps[cx];
                I[cx] = q.nlps;
            }
            a = qe;
        } else {
            c -= qe << 16;
            if (a & 0x8000) return mps[cx];
            if (a < qe) {
                d = 1 - mps[cx];
                if (q.sw) mps[cx] = 1 - mps[cx];
                I[cx] = q.nlps;
            } else { d = mps[cx]; I[cx] = q.nmps; }
        }
        do {
            if (ct == 0) bytein();
            a = (a << 1) & 0xFFFF;
            c <<= 1;
            ct -= 1;
        } while (!(a & 0x8000));
        return d;
    }
};

// zero-coding context tables, built once AT LOAD TIME (static initializer
// below): ctypes calls release the GIL, so a lazy first-use build would be
// a data race between concurrent decoder threads
int8_t ZC_LL[3][3][5], ZC_HH[5][5][5];
void build_zc() {
    for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
            for (int d = 0; d < 5; ++d) {
                int cc;
                if (h == 2) cc = 8;
                else if (h == 1) cc = v >= 1 ? 7 : (d >= 1 ? 6 : 5);
                else {
                    if (v == 2) cc = 4;
                    else if (v == 1) cc = 3;
                    else cc = d >= 2 ? 2 : (d == 1 ? 1 : 0);
                }
                ZC_LL[h][v][d] = (int8_t)cc;
            }
    for (int h = 0; h < 5; ++h)
        for (int v = 0; v < 5; ++v) {
            int hv = h + v; if (hv > 4) hv = 4;
            for (int d = 0; d < 5; ++d) {
                int cc;
                if (d >= 3) cc = 8;
                else if (d == 2) cc = hv >= 1 ? 7 : 6;
                else if (d == 1) cc = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
                else cc = hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
                ZC_HH[h][v][d] = (int8_t)cc;
            }
        }
}
const bool zc_initialized = (build_zc(), true);

// sign coding: sc_ctx[hc+1][vc+1], sc_xor likewise
const int SC_CTX[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
const int SC_XOR[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};

struct T1 {
    int w, h, orient;
    std::vector<uint8_t> sig, sgn, vis, ref;  // (h+2) x (w+2)
    std::vector<int64_t> mag;                  // h x w
    int W2;

    void init(int ww, int hh, int oo) {
        w = ww; h = hh; orient = oo; W2 = w + 2;
        sig.assign((h + 2) * W2, 0);
        sgn.assign((h + 2) * W2, 0);
        vis.assign((h + 2) * W2, 0);
        ref.assign((h + 2) * W2, 0);
        mag.assign((int64_t)h * w, 0);
    }
    inline int idx(int y, int x) const { return y * W2 + x; }
    int zc_ctx(int y, int x) const {
        const uint8_t* s = sig.data();
        int i = idx(y, x);
        int hh = s[i - 1] + s[i + 1];
        int vv = s[i - W2] + s[i + W2];
        int dd = s[i - W2 - 1] + s[i - W2 + 1] + s[i + W2 - 1] + s[i + W2 + 1];
        if (dd > 4) dd = 4;
        if (orient == 0 || orient == 2) return ZC_LL[hh][vv][dd];
        if (orient == 1) return ZC_LL[vv][hh][dd];
        return ZC_HH[hh][vv][dd];
    }
    int sc_decode(MQ& mq, int y, int x) {
        const uint8_t* s = sig.data();
        const uint8_t* g = sgn.data();
        int i = idx(y, x);
        auto contrib = [&](int a, int b) {
            int sa = s[a] ? (g[a] ? -1 : 1) : 0;
            int sb = s[b] ? (g[b] ? -1 : 1) : 0;
            int t = sa + sb;
            return t < -1 ? -1 : (t > 1 ? 1 : t);
        };
        int hc = contrib(i - 1, i + 1);
        int vc = contrib(i - W2, i + W2);
        int ctx = SC_CTX[hc + 1][vc + 1];
        int xr = SC_XOR[hc + 1][vc + 1];
        return mq.decode(ctx) ^ xr;
    }

    void sig_pass(MQ& mq, int plane) {
        for (int y0 = 1; y0 <= h; y0 += 4)
            for (int x = 1; x <= w; ++x) {
                int yend = y0 + 4 <= h + 1 ? y0 + 4 : h + 1;
                for (int y = y0; y < yend; ++y) {
                    int i = idx(y, x);
                    if (sig[i]) continue;
                    int ctx = zc_ctx(y, x);
                    if (ctx == 0) continue;
                    vis[i] = 1;
                    if (mq.decode(ctx)) {
                        int neg = sc_decode(mq, y, x);
                        sig[i] = 1;
                        sgn[i] = (uint8_t)neg;
                        mag[(int64_t)(y - 1) * w + (x - 1)] = (int64_t)1 << plane;
                    }
                }
            }
    }
    void mag_pass(MQ& mq, int plane) {
        const uint8_t* s = sig.data();
        for (int y0 = 1; y0 <= h; y0 += 4)
            for (int x = 1; x <= w; ++x) {
                int yend = y0 + 4 <= h + 1 ? y0 + 4 : h + 1;
                for (int y = y0; y < yend; ++y) {
                    int i = idx(y, x);
                    if (!sig[i] || vis[i]) continue;
                    int ctx;
                    if (ref[i]) ctx = 16;
                    else {
                        int nbr = s[i-1] + s[i+1] + s[i-W2] + s[i+W2]
                                + s[i-W2-1] + s[i-W2+1] + s[i+W2-1] + s[i+W2+1];
                        ctx = nbr ? 15 : 14;
                        ref[i] = 1;
                    }
                    int bit = mq.decode(ctx);
                    mag[(int64_t)(y - 1) * w + (x - 1)] |= (int64_t)bit << plane;
                    vis[i] = 1;
                }
            }
    }
    int cleanup_pass(MQ& mq, int plane, int segsym) {
        for (int y0 = 1; y0 <= h; y0 += 4) {
            bool full = y0 + 3 <= h;
            for (int x = 1; x <= w; ++x) {
                int y = y0;
                if (full) {
                    bool rl = true;
                    for (int yy = y0; yy < y0 + 4; ++yy) {
                        int i = idx(yy, x);
                        if (sig[i] || vis[i] || zc_ctx(yy, x) != 0) { rl = false; break; }
                    }
                    if (rl) {
                        if (mq.decode(CX_RL) == 0) {
                            for (int yy = y0; yy < y0 + 4; ++yy) vis[idx(yy, x)] = 0;
                            continue;
                        }
                        int r = (mq.decode(CX_UNI) << 1) | mq.decode(CX_UNI);
                        y = y0 + r;
                        int neg = sc_decode(mq, y, x);
                        int i = idx(y, x);
                        sig[i] = 1;
                        sgn[i] = (uint8_t)neg;
                        mag[(int64_t)(y - 1) * w + (x - 1)] = (int64_t)1 << plane;
                        y += 1;
                    }
                }
                int yend = y0 + 4 <= h + 1 ? y0 + 4 : h + 1;
                for (int yy = y; yy < yend; ++yy) {
                    int i = idx(yy, x);
                    if (vis[i]) { vis[i] = 0; continue; }
                    if (sig[i]) { vis[i] = 0; continue; }
                    if (mq.decode(zc_ctx(yy, x))) {
                        int neg = sc_decode(mq, yy, x);
                        sig[i] = 1;
                        sgn[i] = (uint8_t)neg;
                        mag[(int64_t)(yy - 1) * w + (x - 1)] = (int64_t)1 << plane;
                    }
                }
            }
        }
        std::fill(vis.begin(), vis.end(), 0);
        if (segsym) {
            int s = (mq.decode(CX_UNI) << 3) | (mq.decode(CX_UNI) << 2)
                  | (mq.decode(CX_UNI) << 1) | mq.decode(CX_UNI);
            if (s != 0x0A) return -1;
        }
        return 0;
    }
};

}  // namespace

extern "C" {

// Decode one code-block: n_passes starting at the cleanup of msb_plane.
// out: w*h signed coefficient values. Returns 0, or -1 on error.
int32_t j2k_decode_block(const uint8_t* data, int64_t nbytes, int32_t w,
                         int32_t h, int32_t orient, int32_t n_passes,
                         int32_t msb_plane, int32_t segsym, int64_t* out) {
    T1 t1;
    t1.init(w, h, orient);
    MQ mq;
    mq.init(data, nbytes);
    int plane = msb_plane;
    int kind = 2;
    for (int p = 0; p < n_passes; ++p) {
        if (plane < 0) return -1;
        if (kind == 0) t1.sig_pass(mq, plane);
        else if (kind == 1) t1.mag_pass(mq, plane);
        else if (t1.cleanup_pass(mq, plane, segsym) != 0) return -1;
        if (kind == 2) { plane -= 1; kind = 0; }
        else kind += 1;
    }
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int64_t v = t1.mag[(int64_t)y * w + x];
            if (t1.sgn[t1.idx(y + 1, x + 1)]) v = -v;
            out[(int64_t)y * w + x] = v;
        }
    return 0;
}

}  // extern "C"
