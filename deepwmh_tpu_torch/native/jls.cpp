// Native JPEG-LS (ITU-T T.87 / LOCO-I) scan decoder — the per-sample
// context-modelling loop of core/jlscodec.py as a C++ kernel (~50x the
// Python loop). The Python layer parses markers and passes the entropy
// bytes + parameters; this kernel decodes one single-component,
// non-interleaved scan. The reference ships this workload to dcm2niix's
// embedded CharLS (deepwmh/external_tools/dcm2niix.py:54).
//
// Mirrors jlscodec._codec decode semantics exactly — the Python test suite
// asserts bit-for-bit equal output between the two implementations.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kMinC = -128, kMaxC = 127;

struct BitReader {
    const uint8_t* buf;
    int64_t n, pos;
    uint64_t acc;
    int bits;
    bool ff;
    bool bad;

    void fill(int need) {
        while (bits < need) {
            if (pos >= n) {
                // synthetic zero pad past end-of-data: 8-bit chunks with
                // ff untouched — byte-for-byte what the Python reader's
                // _fill does, so truncated streams decode identically in
                // both implementations
                acc <<= 8;
                bits += 8;
                continue;
            }
            uint8_t b = buf[pos];
            ++pos;
            if (ff) {  // byte after 0xFF carries 7 payload bits (A.1)
                acc = (acc << 7) | (uint64_t)(b & 0x7F);
                bits += 7;
            } else {
                acc = (acc << 8) | (uint64_t)b;
                bits += 8;
            }
            ff = (b == 0xFF);
        }
    }
    int64_t get(int k) {
        if (k == 0) return 0;
        fill(k);
        bits -= k;
        int64_t v = (int64_t)((acc >> bits) & (((uint64_t)1 << k) - 1));
        acc &= ((uint64_t)1 << bits) - 1;
        return v;
    }
    int unary() {
        int count = 0;
        for (;;) {
            fill(1);
            --bits;
            int bit = (int)((acc >> bits) & 1);
            acc &= ((uint64_t)1 << bits) - 1;
            if (bit) return count;
            if (++count > 64) { bad = true; return 0; }
        }
    }
};

struct State {
    int64_t A[367], B[365], N[367], Nn[2];
    int C[365];
};

inline int quantize(int64_t d, int t1, int t2, int t3, int near) {
    if (d <= -t3) return -4;
    if (d <= -t2) return -3;
    if (d <= -t1) return -2;
    if (d < -near) return -1;
    if (d <= near) return 0;
    if (d < t1) return 1;
    if (d < t2) return 2;
    if (d < t3) return 3;
    return 4;
}

inline int64_t mod_range(int64_t e, int64_t range) {
    if (e < 0) e += range;
    if (e >= (range + 1) / 2) e -= range;
    return e;
}

inline int k_for(int64_t n, int64_t a) {
    int k = 0;
    while ((n << k) < a) ++k;
    return k;
}

inline int64_t golomb_decode(BitReader& br, int k, int limit, int qbpp) {
    int high = br.unary();
    if (br.bad) return 0;
    if (high < limit - qbpp - 1) return ((int64_t)high << k) | br.get(k);
    if (high != limit - qbpp - 1) { br.bad = true; return 0; }
    return br.get(qbpp) + 1;
}

struct Params {
    int64_t w, h, maxval, range;
    int near, t1, t2, t3, reset, qbpp, limit;
};

void update_regular(State& st, int q, int64_t errval, const Params& p) {
    st.B[q] += errval * (2 * p.near + 1);
    st.A[q] += errval < 0 ? -errval : errval;
    if (st.N[q] == p.reset) {
        st.A[q] >>= 1;
        st.B[q] = st.B[q] >= 0 ? (st.B[q] >> 1) : -((1 - st.B[q]) >> 1);
        st.N[q] >>= 1;
    }
    st.N[q] += 1;
    if (st.B[q] <= -st.N[q]) {
        st.B[q] += st.N[q];
        if (st.C[q] > kMinC) st.C[q] -= 1;
        if (st.B[q] <= -st.N[q]) st.B[q] = -st.N[q] + 1;
    } else if (st.B[q] > 0) {
        st.B[q] -= st.N[q];
        if (st.C[q] < kMaxC) st.C[q] += 1;
        if (st.B[q] > 0) st.B[q] = 0;
    }
}

int64_t ri_decode(BitReader& br, State& st, int64_t ra, int64_t rb,
                  const Params& p, int run_index) {
    int64_t ad = ra - rb;
    if (ad < 0) ad = -ad;
    int ritype = ad <= p.near ? 1 : 0;
    int64_t px = ritype ? ra : rb;
    int q = 365 + ritype;
    int64_t temp = st.A[q] + (ritype ? (st.N[q] >> 1) : 0);
    int k = k_for(st.N[q], temp);
    int64_t emerr =
        golomb_decode(br, k, p.limit - kJ[run_index] - 1, p.qbpp);
    if (br.bad) return 0;
    int m = (int)((emerr + ritype) & 1);
    int64_t mag = (emerr + ritype + m) >> 1;
    int64_t errval = 0;
    if (mag != 0) {
        bool positive =
            (m == 1) == (k == 0 && 2 * st.Nn[q - 365] < st.N[q]);
        errval = positive ? mag : -mag;
    }
    // update (A.7.2.2)
    if (errval < 0) st.Nn[q - 365] += 1;
    st.A[q] += (emerr + 1 - ritype) >> 1;
    if (st.N[q] == p.reset) {
        st.A[q] >>= 1;
        st.N[q] >>= 1;
        st.Nn[q - 365] >>= 1;
    }
    st.N[q] += 1;

    int64_t e = errval;
    if (p.near) e *= 2 * p.near + 1;
    int64_t sgn = (ritype == 0 && ra > rb) ? -1 : 1;
    int64_t rx = px + sgn * e;
    if (rx < -p.near) rx += p.range * (2 * p.near + 1);
    else if (rx > p.maxval + p.near) rx -= p.range * (2 * p.near + 1);
    if (rx < 0) rx = 0;
    if (rx > p.maxval) rx = p.maxval;
    return rx;
}

}  // namespace

extern "C" {

// Decode one JPEG-LS scan (single component, ILV=0). Returns 0 on
// success, -1 on a corrupt stream. out must hold h*w int64.
int32_t jls_decode_scan(const uint8_t* data, int64_t nbytes, int64_t w,
                        int64_t h, int64_t maxval, int32_t near,
                        int32_t t1, int32_t t2, int32_t t3, int32_t reset,
                        int32_t qbpp, int32_t limit, int64_t* out) {
    Params p;
    p.w = w; p.h = h; p.maxval = maxval; p.near = near;
    p.t1 = t1; p.t2 = t2; p.t3 = t3; p.reset = reset;
    p.qbpp = qbpp; p.limit = limit;
    p.range = (maxval + 2 * near) / (2 * near + 1) + 1;

    BitReader br{data, nbytes, 0, 0, 0, false, false};
    State st;
    int64_t a0 = (p.range + 32) / 64;
    if (a0 < 2) a0 = 2;
    for (int i = 0; i < 367; ++i) { st.A[i] = a0; st.N[i] = 1; }
    memset(st.B, 0, sizeof(st.B));
    memset(st.C, 0, sizeof(st.C));
    st.Nn[0] = st.Nn[1] = 0;

    std::vector<int64_t> prev_buf((size_t)w + 2, 0), cur_buf((size_t)w + 2, 0);
    int64_t* prev = prev_buf.data();
    int64_t* cur = cur_buf.data();
    int run_index = 0;

    for (int64_t y = 0; y < h; ++y) {
        cur[0] = prev[1];
        int64_t x = 1;
        while (x <= w) {
            int64_t ra = cur[x - 1], rb = prev[x], rc = prev[x - 1],
                    rd = prev[x + 1];
            int q1 = quantize(rd - rb, t1, t2, t3, near);
            int q2 = quantize(rb - rc, t1, t2, t3, near);
            int q3 = quantize(rc - ra, t1, t2, t3, near);

            if (q1 == 0 && q2 == 0 && q3 == 0) {
                // run mode (A.7)
                for (;;) {
                    if (br.get(1) == 1) {
                        int64_t count = (int64_t)1 << kJ[run_index];
                        int64_t fill = count;
                        if (fill > w - x + 1) fill = w - x + 1;
                        for (int64_t i = 0; i < fill; ++i) cur[x++] = ra;
                        if (fill == count) {
                            if (run_index < 31) ++run_index;
                            if (x > w) break;
                            continue;
                        }
                        break;  // partial fill: run to end of line
                    }
                    int64_t rem =
                        kJ[run_index] ? br.get(kJ[run_index]) : 0;
                    for (int64_t i = 0; i < rem; ++i) {
                        if (x > w) { br.bad = true; break; }
                        cur[x++] = ra;
                    }
                    if (x > w || br.bad) { br.bad = true; break; }
                    rb = prev[x];
                    cur[x++] = ri_decode(br, st, ra, rb, p, run_index);
                    if (run_index > 0) --run_index;
                    break;
                }
                if (br.bad) return -1;
                continue;
            }

            // regular mode (A.4-A.6)
            int sign;
            int q;
            if (q1 < 0 || (q1 == 0 && (q2 < 0 || (q2 == 0 && q3 < 0)))) {
                sign = -1;
                q = -(q1 * 81 + q2 * 9 + q3);
            } else {
                sign = 1;
                q = q1 * 81 + q2 * 9 + q3;
            }
            int64_t mn = ra < rb ? ra : rb, mx = ra < rb ? rb : ra;
            int64_t px;
            if (rc >= mx) px = mn;
            else if (rc <= mn) px = mx;
            else px = ra + rb - rc;
            px += sign > 0 ? st.C[q] : -st.C[q];
            if (px < 0) px = 0;
            if (px > p.maxval) px = p.maxval;

            int k = k_for(st.N[q], st.A[q]);
            bool special = near == 0 && k == 0 && 2 * st.B[q] <= -st.N[q];
            int64_t merr = golomb_decode(br, k, p.limit, p.qbpp);
            if (br.bad) return -1;
            int64_t errval;
            if (special)
                errval = (merr & 1) ? (merr - 1) / 2 : -(merr / 2) - 1;
            else
                errval = (merr & 1) ? -((merr + 1) / 2) : merr / 2;
            update_regular(st, q, errval, p);
            if (near) errval *= 2 * near + 1;
            int64_t rx = px + sign * errval;
            if (rx < -near) rx += p.range * (2 * near + 1);
            else if (rx > p.maxval + near) rx -= p.range * (2 * near + 1);
            if (rx < 0) rx = 0;
            if (rx > p.maxval) rx = p.maxval;
            cur[x] = rx;
            ++x;
        }
        memcpy(out + y * w, cur + 1, w * sizeof(int64_t));
        cur[w + 1] = cur[w];
        int64_t* t = prev; prev = cur; cur = t;
        prev[w + 1] = prev[w];
    }
    return 0;
}

}  // extern "C"
