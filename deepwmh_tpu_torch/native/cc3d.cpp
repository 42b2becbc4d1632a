// Native host-side kernels for deepwmh_tpu.
//
// The reference delegates all native compute to external C++ binaries
// (ANTs/ROBEX/FSL, SURVEY.md §2.1); the TPU rebuild keeps the heavy math on
// the accelerator but gives the HOST runtime its own native kernels for the
// irregular / IO-bound work that would bottleneck a single host core in
// Python:
//   - 3D connected components (6-connectivity union-find, two-pass)
//   - component volume filtering (spark removal) in one pass
//   - gzip (de)compression via zlib for the NIfTI codec hot path
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image). Build: see Makefile (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------- //
// union-find connected components, 6-connectivity, raster two-pass
// ---------------------------------------------------------------------- //

static inline int32_t uf_find(std::vector<int32_t> &parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

static inline void uf_union(std::vector<int32_t> &parent, int32_t a, int32_t b) {
  a = uf_find(parent, a);
  b = uf_find(parent, b);
  if (a < b) parent[b] = a;
  else if (b < a) parent[a] = b;
}

// mask: uint8 [D*H*W] (C order), labels out: int32 [D*H*W], 0 = background,
// components numbered 1..n in raster order of first voxel (scipy-compatible).
// Returns n.
int32_t label_components_3d(const uint8_t *mask, int32_t D, int32_t H, int32_t W,
                            int32_t *labels) {
  const int64_t N = (int64_t)D * H * W;
  std::vector<int32_t> parent(1, 0);  // parent[0] unused (background)
  std::vector<int32_t> provisional((size_t)N, 0);

  const int64_t sD = (int64_t)H * W, sH = W;
  for (int64_t d = 0; d < D; ++d) {
    for (int64_t h = 0; h < H; ++h) {
      for (int64_t w = 0; w < W; ++w) {
        const int64_t i = d * sD + h * sH + w;
        if (!mask[i]) continue;
        int32_t up = (h > 0 && mask[i - sH]) ? provisional[i - sH] : 0;
        int32_t left = (w > 0 && mask[i - 1]) ? provisional[i - 1] : 0;
        int32_t back = (d > 0 && mask[i - sD]) ? provisional[i - sD] : 0;
        int32_t lbl = 0;
        if (up) lbl = up;
        if (left) lbl = lbl ? std::min(lbl, left) : left;
        if (back) lbl = lbl ? std::min(lbl, back) : back;
        if (!lbl) {
          lbl = (int32_t)parent.size();
          parent.push_back(lbl);
        }
        provisional[i] = lbl;
        if (up && up != lbl) uf_union(parent, up, lbl);
        if (left && left != lbl) uf_union(parent, left, lbl);
        if (back && back != lbl) uf_union(parent, back, lbl);
      }
    }
  }

  // flatten + renumber in raster order of first appearance
  std::vector<int32_t> remap(parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < N; ++i) {
    if (!provisional[i]) { labels[i] = 0; continue; }
    int32_t root = uf_find(parent, provisional[i]);
    if (!remap[root]) remap[root] = ++next;
    labels[i] = remap[root];
  }
  return next;
}

// Remove components with volume < min_volume. mask in/out uint8.
// Returns number of surviving components.
int32_t remove_small_components(uint8_t *mask, int32_t D, int32_t H, int32_t W,
                                int64_t min_volume) {
  const int64_t N = (int64_t)D * H * W;
  std::vector<int32_t> labels((size_t)N);
  int32_t n = label_components_3d(mask, D, H, W, labels.data());
  std::vector<int64_t> volume((size_t)n + 1, 0);
  for (int64_t i = 0; i < N; ++i) volume[labels[i]]++;
  int32_t kept = 0;
  std::vector<uint8_t> keep((size_t)n + 1, 0);
  for (int32_t c = 1; c <= n; ++c) {
    if (volume[c] >= min_volume) { keep[c] = 1; ++kept; }
  }
  for (int64_t i = 0; i < N; ++i) mask[i] = labels[i] ? keep[labels[i]] : 0;
  return kept;
}

// ---------------------------------------------------------------------- //
// gzip helpers (zlib) for the NIfTI codec
// ---------------------------------------------------------------------- //

// zlib's counters are uInt (32-bit): buffers are fed in <=1 GiB chunks so
// int64 sizes (multi-GiB volumes) never truncate. The chunk size is
// settable for tests (tiny chunks exercise the refill logic without
// multi-GiB fixtures).
static int64_t g_zchunk = (int64_t)1 << 30;

void gzip_set_chunk_for_testing(int64_t chunk) {
  g_zchunk = chunk > 0 ? chunk : ((int64_t)1 << 30);
}

static uInt refill(int64_t want, int64_t *left) {
  int64_t n = want < *left ? want : *left;
  *left -= n;
  return (uInt)n;
}

// Inflate a gzip stream (including MULTI-MEMBER files as produced by
// pigz/bgzip: after each Z_STREAM_END, remaining input starts a new
// member). Returns total decompressed size, -1 on corrupt/truncated input,
// or -2 if out_capacity is too small.
int64_t gzip_inflate(const uint8_t *src, int64_t src_len, uint8_t *dst,
                     int64_t dst_capacity) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return -1;
  zs.next_in = const_cast<Bytef *>(src);
  zs.next_out = dst;
  int64_t in_left = src_len, out_left = dst_capacity;
  zs.avail_in = refill(g_zchunk, &in_left);
  zs.avail_out = refill(g_zchunk, &out_left);
  for (;;) {
    int ret = inflate(&zs, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) {
      if (zs.avail_in == 0 && in_left == 0) {
        int64_t total = dst_capacity - out_left - (int64_t)zs.avail_out;
        inflateEnd(&zs);
        return total;
      }
      // another gzip member follows
      if (inflateReset2(&zs, 16 + MAX_WBITS) != Z_OK) {
        inflateEnd(&zs);
        return -1;
      }
      continue;
    }
    if (ret == Z_OK || ret == Z_BUF_ERROR) {
      bool refilled = false;
      if (zs.avail_in == 0 && in_left > 0) {
        zs.avail_in = refill(g_zchunk, &in_left);
        refilled = true;
      }
      if (zs.avail_out == 0 && out_left > 0) {
        zs.avail_out = refill(g_zchunk, &out_left);
        refilled = true;
      }
      if (refilled || ret == Z_OK) continue;
      bool out_full = (zs.avail_out == 0);
      inflateEnd(&zs);
      // only a FULL output buffer means "need more space"; otherwise the
      // input is truncated/corrupt
      return out_full ? -2 : -1;
    }
    inflateEnd(&zs);
    return -1;
  }
}

// Deflate to gzip. Returns compressed size, -1 on error (including a too-
// small destination buffer).
int64_t gzip_deflate(const uint8_t *src, int64_t src_len, uint8_t *dst,
                     int64_t dst_capacity, int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 16 + MAX_WBITS, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<Bytef *>(src);
  zs.next_out = dst;
  int64_t in_left = src_len, out_left = dst_capacity;
  zs.avail_in = refill(g_zchunk, &in_left);
  zs.avail_out = refill(g_zchunk, &out_left);
  for (;;) {
    int flush = (zs.avail_in == 0 && in_left == 0) ? Z_FINISH : Z_NO_FLUSH;
    int ret = deflate(&zs, flush);
    if (ret == Z_STREAM_END) {
      int64_t out = dst_capacity - out_left - (int64_t)zs.avail_out;
      deflateEnd(&zs);
      return out;
    }
    if (ret == Z_OK || ret == Z_BUF_ERROR) {
      bool refilled = false;
      if (zs.avail_in == 0 && in_left > 0) {
        zs.avail_in = refill(g_zchunk, &in_left);
        refilled = true;
      }
      if (zs.avail_out == 0 && out_left > 0) {
        zs.avail_out = refill(g_zchunk, &out_left);
        refilled = true;
      }
      if (refilled || ret == Z_OK) continue;
      deflateEnd(&zs);  // no refill possible: dst too small
      return -1;
    }
    deflateEnd(&zs);
    return -1;
  }
}

}  // extern "C"
