// dvc_native: host-side C++ core for the WAN (DCN) averaging path.
//
// TPU-native stand-in for the native tier of the reference stack: the
// reference's collectives ride NCCL/gloo (C++); here the intra-slice tier is
// XLA-emitted ICI collectives (no code to write), and THIS library covers the
// host/WAN tier those libraries covered — payload checksums, wire codecs and
// robust reduction over peer contributions (SURVEY.md §2 native-code
// checklist). Exposed as a plain C ABI and bound from Python with ctypes
// (no pybind11 in this environment).
//
// Everything here is trivially parallel over the buffer, so each entry point
// slices the work across a small std::thread pool — these run on the
// volunteer HOST next to param-sized buffers (10^7..10^9 bytes) while the
// TPU step runs, so wall-clock here is overlap budget for the WAN round.

#include <algorithm>
#include <cmath>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : n;
}

// Run fn(begin, end) over [0, n) in roughly equal chunks on up to max_thr
// threads; serial when the buffer is too small to amortise thread spawn.
template <typename F>
void parallel_for(uint64_t n, uint64_t serial_cutoff, F fn) {
  unsigned max_thr = hw_threads();
  if (n < serial_cutoff || max_thr <= 1) {
    fn(0, n);
    return;
  }
  unsigned thr = static_cast<unsigned>(
      std::min<uint64_t>(max_thr, (n + serial_cutoff - 1) / serial_cutoff));
  std::vector<std::thread> pool;
  pool.reserve(thr);
  uint64_t chunk = (n + thr - 1) / thr;
  for (unsigned t = 0; t < thr; ++t) {
    uint64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    pool.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// CRC32 (zlib polynomial 0xEDB88320), slice-by-8.
// ---------------------------------------------------------------------------

struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = t[s - 1][i] >> 8 ^ t[0][t[s - 1][i] & 0xFF];
  }
};
const Crc32Tables kCrc;

uint32_t crc32_serial(const uint8_t* p, uint64_t len, uint32_t crc) {
  crc = ~crc;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
          kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
          kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) crc = kCrc.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// GF(2) trick to combine per-chunk CRCs: crc(A||B) from crc(A), crc(B), |B|.
uint32_t gf2_times(uint32_t a, const uint32_t* mat) {
  uint32_t s = 0;
  for (int i = 0; a; ++i, a >>= 1)
    if (a & 1) s ^= mat[i];
  return s;
}

void gf2_square(uint32_t* sq, const uint32_t* mat) {
  for (int i = 0; i < 32; ++i) sq[i] = gf2_times(mat[i], mat);
}

uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  if (len2 == 0) return crc1;
  uint32_t even[32], odd[32];
  odd[0] = 0xEDB88320u;
  for (int i = 1; i < 32; ++i) odd[i] = 1u << (i - 1);
  gf2_square(even, odd);
  gf2_square(odd, even);
  do {
    gf2_square(even, odd);
    if (len2 & 1) crc1 = gf2_times(crc1, even);
    len2 >>= 1;
    if (!len2) break;
    gf2_square(odd, even);
    if (len2 & 1) crc1 = gf2_times(crc1, odd);
    len2 >>= 1;
  } while (len2);
  return crc1 ^ crc2;
}

// ---------------------------------------------------------------------------
// f32 <-> bf16 (round-to-nearest-even), the wire codec.
// ---------------------------------------------------------------------------

inline uint16_t f32_to_bf16_1(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7FFFFFFFu) > 0x7F800000u) return static_cast<uint16_t>(x >> 16) | 0x40;  // quiet NaN
  uint32_t rounding = 0x7FFFu + ((x >> 16) & 1);
  return static_cast<uint16_t>((x + rounding) >> 16);
}

}  // namespace

extern "C" {

int dvc_abi_version() { return 3; }

uint32_t dvc_crc32(const uint8_t* data, uint64_t len, uint32_t seed) {
  const uint64_t kCut = 1 << 20;
  unsigned thr = hw_threads();
  if (len < 2 * kCut || thr <= 1) return crc32_serial(data, len, seed);
  thr = static_cast<unsigned>(std::min<uint64_t>(thr, len / kCut));
  uint64_t chunk = (len + thr - 1) / thr;
  std::vector<uint32_t> crcs(thr, 0);
  std::vector<uint64_t> lens(thr, 0);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < thr; ++t) {
    uint64_t b = t * chunk, e = std::min(len, b + chunk);
    if (b >= e) break;
    lens[t] = e - b;
    pool.emplace_back([&, t, b, e] { crcs[t] = crc32_serial(data + b, e - b, 0); });
  }
  for (auto& th : pool) th.join();
  uint32_t crc = seed;
  for (unsigned t = 0; t < pool.size(); ++t) crc = crc32_combine(crc, crcs[t], lens[t]);
  return crc;
}

void dvc_f32_to_bf16(const float* src, uint16_t* dst, uint64_t n) {
  parallel_for(n, 1 << 18, [&](uint64_t b, uint64_t e) {
    for (uint64_t i = b; i < e; ++i) dst[i] = f32_to_bf16_1(src[i]);
  });
}

void dvc_bf16_to_f32(const uint16_t* src, float* dst, uint64_t n) {
  parallel_for(n, 1 << 18, [&](uint64_t b, uint64_t e) {
    for (uint64_t i = b; i < e; ++i) {
      uint32_t x = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(&dst[i], &x, 4);
    }
  });
}

// acc += w * x, the leader-gather accumulation.
void dvc_weighted_sum(float* acc, const float* x, float w, uint64_t n) {
  parallel_for(n, 1 << 18, [&](uint64_t b, uint64_t e) {
    for (uint64_t i = b; i < e; ++i) acc[i] += w * x[i];
  });
}

// Robust reduction over stack[n_peers, dim] (row-major), coordinate-wise,
// threaded over dim. n_peers is swarm-scale (<= 64), so a stack buffer +
// insertion-grade std::sort per coordinate beats numpy's full-matrix sort
// (which allocates and sorts the whole [n, D] copy single-threaded).
void dvc_coord_median(const float* stack, uint64_t n_peers, uint64_t dim, float* out) {
  parallel_for(dim, 1 << 14, [&](uint64_t b, uint64_t e) {
    std::vector<float> col(n_peers);
    for (uint64_t j = b; j < e; ++j) {
      for (uint64_t i = 0; i < n_peers; ++i) col[i] = stack[i * dim + j];
      std::sort(col.begin(), col.end());
      out[j] = (n_peers & 1)
                   ? col[n_peers / 2]
                   : 0.5f * (col[n_peers / 2 - 1] + col[n_peers / 2]);
    }
  });
}

void dvc_trimmed_mean(const float* stack, uint64_t n_peers, uint64_t dim,
                      uint64_t trim, float* out) {
  if (2 * trim >= n_peers) return;  // caller validates; keep ABI total
  parallel_for(dim, 1 << 14, [&](uint64_t b, uint64_t e) {
    std::vector<float> col(n_peers);
    for (uint64_t j = b; j < e; ++j) {
      for (uint64_t i = 0; i < n_peers; ++i) col[i] = stack[i * dim + j];
      std::sort(col.begin(), col.end());
      double s = 0;
      for (uint64_t i = trim; i < n_peers - trim; ++i) s += col[i];
      out[j] = static_cast<float>(s / static_cast<double>(n_peers - 2 * trim));
    }
  });
}

// Chunked symmetric int8 quantization for the WAN wire ("q8" codec):
// per-chunk scale = absmax/127, values round to int8. ~4x fewer DCN bytes
// than f32 (2x vs bf16) at <=0.4% per-element relative error within a
// chunk; round-tripping already-quantized values is exact (the scale
// reconstructs bit-identically), which pairwise protocols rely on.
// Non-finite inputs are mapped to 0 BEFORE scaling: a diverged peer's
// NaN/Inf must not poison the chunk scale or hit the UB of casting a
// non-finite float to int8 (robust aggregation / the state-sync sanity
// guard are the layers that deal with divergent peers; the codec's job is
// merely to never corrupt silently or invoke UB).
void dvc_f32_to_q8(const float* in, uint64_t n, uint64_t chunk, float* scales,
                   int8_t* out) {
  if (chunk == 0) return;
  uint64_t n_chunks = (n + chunk - 1) / chunk;
  parallel_for(n_chunks, 8, [&](uint64_t b, uint64_t e) {
    for (uint64_t c = b; c < e; ++c) {
      uint64_t lo = c * chunk, hi = std::min(n, lo + chunk);
      float amax = 0.0f;
      for (uint64_t i = lo; i < hi; ++i) {
        float v = in[i];
        if (!std::isfinite(v)) continue;
        float a = v < 0 ? -v : v;
        if (a > amax) amax = a;
      }
      float scale = amax > 0 ? amax / 127.0f : 1.0f;
      scales[c] = scale;
      float inv = 1.0f / scale;
      for (uint64_t i = lo; i < hi; ++i) {
        float v = std::isfinite(in[i]) ? in[i] : 0.0f;
        float q = v * inv;
        q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
        out[i] = static_cast<int8_t>(q >= 0 ? q + 0.5f : q - 0.5f);
      }
    }
  });
}

void dvc_q8_to_f32(const int8_t* in, const float* scales, uint64_t n,
                   uint64_t chunk, float* out) {
  if (chunk == 0) return;
  uint64_t n_chunks = (n + chunk - 1) / chunk;
  parallel_for(n_chunks, 8, [&](uint64_t b, uint64_t e) {
    for (uint64_t c = b; c < e; ++c) {
      uint64_t lo = c * chunk, hi = std::min(n, lo + chunk);
      float scale = scales[c];
      for (uint64_t i = lo; i < hi; ++i)
        out[i] = static_cast<float>(in[i]) * scale;
    }
  });
}

// Indices of the k largest-|value| entries, ascending index order (the
// top-k sparse wire codec's selection phase). Caller guarantees finite
// input (the Python side zeroes NaN/Inf first) and 0 < k <= n. Threshold
// via nth_element on a magnitude copy, then one in-order scan emitting
// strictly-above-threshold entries plus as many threshold-equal ones as k
// still needs — output is sorted by construction, as the wire format
// requires.
void dvc_topk_indices(const float* in, uint64_t n, uint64_t k,
                      uint32_t* idx_out) {
  if (k == 0 || k > n) return;
  // One UNINITIALIZED scratch magnitude array (vector would zero-fill n
  // floats serially before the parallel fill overwrites them), consumed
  // destructively by nth_element; the counting/emit scans read |in[i]|
  // directly (fabs is cheaper than a second n-float allocation + copy).
  std::unique_ptr<float[]> mag(new float[n]);
  parallel_for(n, 1u << 16, [&](uint64_t b, uint64_t e) {
    for (uint64_t i = b; i < e; ++i) mag[i] = in[i] < 0 ? -in[i] : in[i];
  });
  std::nth_element(mag.get(), mag.get() + (n - k), mag.get() + n);
  float thr = mag[n - k];
  std::atomic<uint64_t> greater_at{0};
  parallel_for(n, 1u << 16, [&](uint64_t b, uint64_t e) {
    uint64_t g = 0;
    for (uint64_t i = b; i < e; ++i) {
      float a = in[i] < 0 ? -in[i] : in[i];
      if (a > thr) ++g;
    }
    greater_at.fetch_add(g, std::memory_order_relaxed);
  });
  uint64_t need_eq = k - greater_at.load();
  uint64_t w = 0;
  for (uint64_t i = 0; i < n && w < k; ++i) {
    float a = in[i] < 0 ? -in[i] : in[i];
    if (a > thr) {
      idx_out[w++] = static_cast<uint32_t>(i);
    } else if (a == thr && need_eq > 0) {
      idx_out[w++] = static_cast<uint32_t>(i);
      --need_eq;
    }
  }
}

}  // extern "C"
