// Native fast path for the serial entropy-decode loop of lossless JPEG
// (ITU-T T.81 Annex H), the hot part of compressed-DICOM import
// (core/jpegcodec.py). The reference ships this workload to the dcm2niix
// C++ binary (deepwmh/external_tools/dcm2niix.py:54); here it is a small
// in-process kernel instead.
//
// The Python layer parses markers, builds the 16-bit-peek Huffman LUT
// (lut[p] = symbol<<5 | code_length, 0 = invalid) and removes 0xFF00 byte
// stuffing; this kernel only runs the per-sample bit loop, which pure
// Python does ~100x slower.

#include <cstdint>

extern "C" {

// Decode `n` prediction differences from unstuffed entropy-coded data.
// Returns the number of differences decoded (== n on success), or -1 on
// an invalid Huffman code / truncated stream.
int64_t jpegl_decode_diffs(const uint8_t* data, int64_t nbytes,
                           const int32_t* lut, int64_t n,
                           int64_t* out_diffs) {
    uint64_t acc = 0;   // bit accumulator, MSB-first semantics
    int bits = 0;       // valid low bits in acc
    int64_t pos = 0;

    for (int64_t i = 0; i < n; ++i) {
        // fill to at least 32 bits (16 code + up to 16 magnitude);
        // zero-pad past the end (trailing pad bits are never decoded as
        // real samples because the loop is bounded by n)
        while (bits < 32) {
            uint8_t b = pos < nbytes ? data[pos] : 0;
            ++pos;
            acc = (acc << 8) | b;
            bits += 8;
        }
        uint32_t peek = (uint32_t)((acc >> (bits - 16)) & 0xFFFFu);
        int32_t e = lut[peek];
        if (e == 0) return -1;
        int len = e & 31;
        int s = e >> 5;
        // a corrupt DHT can carry any symbol byte; s > 16 or len outside
        // 1..16 would make the shifts below undefined behavior and return
        // garbage as success — honor the error contract instead
        if (len < 1 || len > 16 || s < 0 || s > 16) return -1;
        bits -= len;

        int64_t diff;
        if (s == 0) {
            diff = 0;
        } else if (s == 16) {
            diff = 32768;  // SSSS=16: no magnitude bits (T.81 H.2)
        } else {
            int64_t v = (int64_t)((acc >> (bits - s)) & ((1u << s) - 1));
            bits -= s;
            // EXTEND (T.81 F.2.2.1)
            if (v < (int64_t)1 << (s - 1)) v -= ((int64_t)1 << s) - 1;
            diff = v;
        }
        acc &= (bits >= 64) ? ~0ull : (((uint64_t)1 << bits) - 1);
        out_diffs[i] = diff;
    }
    return n;
}

// Sequential reconstruction for one non-interleaved lossless component
// with any predictor 1-7 (T.81 H.1.2.1), no restart intervals. Values are
// reconstructed mod 2^16 (H.2.1). Used for the rare non-SV1 streams; SV1
// reconstruction is vectorized in numpy instead.
void jpegl_reconstruct(const int64_t* diffs, int64_t h, int64_t w,
                       int32_t psv, int64_t default_pred, int64_t* out) {
    const int64_t mask = 0xFFFF;
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            int64_t pred;
            if (y == 0) {
                pred = (x == 0) ? default_pred : out[x - 1];
            } else if (x == 0) {
                pred = out[(y - 1) * w];
            } else {
                int64_t ra = out[y * w + x - 1];
                int64_t rb = out[(y - 1) * w + x];
                int64_t rc = out[(y - 1) * w + x - 1];
                switch (psv) {
                    case 1: pred = ra; break;
                    case 2: pred = rb; break;
                    case 3: pred = rc; break;
                    case 4: pred = ra + rb - rc; break;
                    case 5: pred = ra + ((rb - rc) >> 1); break;
                    case 6: pred = rb + ((ra - rc) >> 1); break;
                    default: pred = (ra + rb) >> 1; break;
                }
            }
            out[y * w + x] = (pred + diffs[y * w + x]) & mask;
        }
    }
}

}  // extern "C"
