// bf16 wire codec for Hopper (sm_90a): encode (K4) and decode-axpy (K5).
//
// Replaces the Pallas TPU kernels of distributedvolunteercomputing_tpu/ops/
// mesh_codec.py: _enc_kernel (K4, f32 -> bf16 bit patterns) and
// _dec_axpy_kernel (K5, acc + w * widen(bf16 bits)). The TPU versions walk
// (512, 128) VMEM blocks over a sequential grid and only run when the buffer
// is a multiple of that block; here every n > 0 is taken.
//
//  - K4 rounds to nearest even on the bits, subnormals included, exactly as
//    the XLA f32 -> bf16 convert that the TPU kernel lowers to (and as the
//    host codec, native/dvc_native.cpp, on every value but NaN payloads):
//    a NaN encodes as its sign | 0x7fc0, the convert's canonical quiet NaN.
//    No fast-math: the build must not flush subnormals.
//  - K5 folds a staged batch of wire chunks into accumulator rows in place:
//    for each tile u of the batch and each column, the row's value is loaded
//    once, a = a + w_i * float(bits_i << 16) is taken over the tile's chunks
//    i in staging order (each over its own valid length), and the value is
//    stored once. Multiply and add are each rounded (__fmul_rn / __fadd_rn:
//    no contraction into an FMA), so one launch is bit-equal to folding the
//    chunks one after the other (decode_axpy_plain per chunk), repeated
//    tiles, short chunks and zero weights included. The flush's chunk table
//    rides in the kernel's parameter block (__grid_constant__): no device
//    buffer, no host-to-device copy, no synchronisation. The flat
//    decode-axpy is the same launch with one tile and one chunk (the
//    wrapper, ops/mesh_codec.py bf16_decode_axpy).
//
// What bounds them on an H100: bytes. K4 reads 4 B and writes 2 B per
// element: 747 MB (~223 us at 3.35 TB/s) at the flagship buffer (gpt2_small,
// 124,439,808 floats). K5 reads 2 B per chunk element and reads and writes
// 4 B per touched accumulator element: a 16 MiB flush of 1 MiB chunks moves
// ~68-84 MB (~20-25 us). Both are streaming passes with independent lanes,
// so the design is one of bytes in flight: each thread issues four 16-byte
// loads of f32 (and four 8-byte loads of bf16 bits) before it uses any,
// neighbouring threads on neighbouring addresses, with streaming cache hints
// (__ldcs / __stcs: each byte is touched once); the grid covers the data in
// one pass (measured faster than a persistent grid of 8 blocks per SM, which
// also needed the SM count), and a scalar path of the same shape takes
// widths and pointers that are not 16-byte aligned (a ragged shard, an odd
// n). experiments/torch_codec_variants.py times this design against its
// variants, the alternative (TMA bulk copies through a ring of shared-memory
// stages) and the first design (PERF.md).
//
// Plain C interface (bound with ctypes); each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vector groups per thread, loaded before any is used

// K5's chunk table (int32 words), for U tiles and K chunks of one launch:
// row [U] | cols [U] | ptr [U + 1] | chunk row [K] | weight bits [K] | len [K].
// Tile u folds chunks ptr[u] .. ptr[u + 1] (staging order) into accumulator
// row row[u] over its columns [0, cols[u]) (the longest of its chunks); chunk
// j folds bits row chunk_row[j], columns [col0, col0 + len[j]), with weight
// weight[j]. A flagship flush (16 chunks of 1 MiB) needs 97 words, a 16 MiB
// flush of 64 KiB chunks (256 chunks, every tile distinct) 1537; a batch
// whose table does not fit is split by the caller into launches of whole
// tiles (ops/mesh_codec.py fold_plan).
constexpr int kFoldWords = 2032;

struct FoldParams {
  const uint16_t* bits;  // chunk rows
  float* acc;            // accumulator rows, folded in place
  int64_t bits_ld;       // elements between two bits rows
  int64_t acc_ld;        // elements between two accumulator rows
  int64_t col0;          // first column of a bits row that folds into column 0
  int32_t n_tiles;       // U (grid.y)
  int32_t n_chunks;      // K
  int32_t words[kFoldWords];
};
static_assert(sizeof(FoldParams) <= 8192, "K5's parameter block must stay within 8 KB");

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t x = __float_as_uint(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return ((x >> 16) & 0x8000u) | 0x7fc0u;
  return (x + 0x7fffu + ((x >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

// A vector group: 4 lanes (float4 of values, uint2 of bf16 bits) or 1.
template <int kVec>
struct Lanes;

template <>
struct Lanes<4> {
  using F = float4;
  using B = uint2;
  static __device__ __forceinline__ B encode(F v) {
    return make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16), bf16_bits(v.z) | (bf16_bits(v.w) << 16));
  }
  // a + w * widen(b) on the first `valid` lanes (all four when valid >= 4).
  static __device__ __forceinline__ F fold(F a, float w, B b, int64_t valid) {
    if (valid >= 4) {
      a.x = axpy(a.x, w, b.x & 0xffffu);
      a.y = axpy(a.y, w, b.x >> 16);
      a.z = axpy(a.z, w, b.y & 0xffffu);
      a.w = axpy(a.w, w, b.y >> 16);
    } else {
      if (valid > 0) a.x = axpy(a.x, w, b.x & 0xffffu);
      if (valid > 1) a.y = axpy(a.y, w, b.x >> 16);
      if (valid > 2) a.z = axpy(a.z, w, b.y & 0xffffu);
    }
    return a;
  }
};

template <>
struct Lanes<1> {
  using F = float;
  using B = unsigned short;
  static __device__ __forceinline__ B encode(F v) { return static_cast<B>(bf16_bits(v)); }
  static __device__ __forceinline__ F fold(F a, float w, B b, int64_t valid) {
    return valid > 0 ? axpy(a, w, b) : a;
  }
};

// K4: out[i] = bf16 bits of x[i]. Groups of kVec lanes, kUnroll groups a
// thread (a block's kThreads apart, so a warp's loads are contiguous), all
// loaded before any is converted; the last n % kVec lanes by the scalar tail.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    bf16_encode_kernel(const float* __restrict__ x, uint16_t* __restrict__ out, int64_t n) {
  using L = Lanes<kVec>;
  const auto* xv = reinterpret_cast<const typename L::F*>(x);
  auto* ov = reinterpret_cast<typename L::B*>(out);
  const int64_t groups = n / kVec;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  typename L::F v[kUnroll];
#pragma unroll
  for (int t = 0; t < kUnroll; ++t) {
    const int64_t g = g0 + t * kThreads;
    if (g < groups) v[t] = __ldcs(xv + g);
  }
#pragma unroll
  for (int t = 0; t < kUnroll; ++t) {
    const int64_t g = g0 + t * kThreads;
    if (g < groups) __stcs(ov + g, L::encode(v[t]));
  }
  if (kVec > 1 && blockIdx.x == 0) {
    for (int64_t i = groups * kVec + threadIdx.x; i < n; i += kThreads) {
      out[i] = static_cast<uint16_t>(bf16_bits(x[i]));
    }
  }
}

// K5: blockIdx.y is the tile, blockIdx.x its columns in groups of kVec,
// kUnroll groups a thread: the accumulator groups are loaded, each chunk's
// bits groups are loaded and folded in staging order, and the groups are
// stored once. Columns past cols % kVec by the scalar tail of block 0.
template <int kVec>
__global__ void __launch_bounds__(kThreads) bf16_fold_kernel(const __grid_constant__ FoldParams p) {
  using L = Lanes<kVec>;
  const int U = p.n_tiles, K = p.n_chunks, u = blockIdx.y;
  const int32_t* w = p.words;
  const int64_t row = w[u], cols = w[U + u];
  const int j0 = w[2 * U + u], j1 = w[2 * U + u + 1];
  const int32_t* chunk_row = w + 3 * U + 1;
  const int32_t* wbits = chunk_row + K;
  const int32_t* len = wbits + K;
  float* dst = p.acc + row * p.acc_ld;
  const auto* sv = reinterpret_cast<const typename L::F*>(dst);
  auto* dv = reinterpret_cast<typename L::F*>(dst);
  const int64_t groups = cols / kVec;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  typename L::F a[kUnroll];
#pragma unroll
  for (int t = 0; t < kUnroll; ++t) {
    const int64_t g = g0 + t * kThreads;
    if (g < groups) a[t] = __ldcs(sv + g);
  }
  for (int j = j0; j < j1; ++j) {
    const float wj = __int_as_float(wbits[j]);
    const int64_t n = len[j];
    const auto* bv = reinterpret_cast<const typename L::B*>(p.bits + chunk_row[j] * p.bits_ld + p.col0);
    typename L::B b[kUnroll] = {};
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int64_t g = g0 + t * kThreads;
      if (g < groups && g * kVec < n) b[t] = __ldcs(bv + g);
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int64_t g = g0 + t * kThreads;
      if (g < groups) a[t] = L::fold(a[t], wj, b[t], n - g * kVec);
    }
  }
#pragma unroll
  for (int t = 0; t < kUnroll; ++t) {
    const int64_t g = g0 + t * kThreads;
    if (g < groups) __stcs(dv + g, a[t]);
  }
  if (kVec > 1 && blockIdx.x == 0) {
    for (int64_t c = groups * kVec + threadIdx.x; c < cols; c += kThreads) {
      float a = dst[c];
      for (int j = j0; j < j1; ++j) {
        if (c < len[j]) a = axpy(a, __int_as_float(wbits[j]), p.bits[chunk_row[j] * p.bits_ld + p.col0 + c]);
      }
      dst[c] = a;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

// Blocks that cover `groups` vector groups in one pass (at least one).
unsigned blocks_for(int64_t groups) {
  const int64_t want = (groups + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  return static_cast<unsigned>(want < 1 ? 1 : want);
}

// One K5 launch of the table in `p` on `stream`: grid.y the tiles, grid.x
// the widest tile's columns.
cudaError_t launch_fold(const FoldParams& p, bool vec, cudaStream_t stream) {
  int64_t widest = 0;
  for (int u = 0; u < p.n_tiles; ++u) widest = p.words[p.n_tiles + u] > widest ? p.words[p.n_tiles + u] : widest;
  const dim3 grid(blocks_for(vec ? widest / 4 : widest), p.n_tiles);
  if (vec) {
    bf16_fold_kernel<4><<<grid, kThreads, 0, stream>>>(p);
  } else {
    bf16_fold_kernel<1><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// The 16-byte vector path needs every accumulator row of the table and
// every bits row of its chunks (from col0 on) to start on a vector boundary.
bool fold_vectorizable(const FoldParams& p) {
  const int32_t* chunk_row = p.words + 3 * p.n_tiles + 1;
  for (int u = 0; u < p.n_tiles; ++u) {
    if (!aligned(p.acc + p.words[u] * p.acc_ld, 16)) return false;
  }
  for (int j = 0; j < p.n_chunks; ++j) {
    if (!aligned(p.bits + chunk_row[j] * p.bits_ld + p.col0, 8)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

int dvc_bf16_encode(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0 || x == nullptr || out == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<uint16_t*>(out);
  if (aligned(x, 16) && aligned(out, 8)) {
    bf16_encode_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(xf, o, n);
  } else {
    bf16_encode_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(xf, o, n);
  }
  return cudaGetLastError();
}

// K5 over one staged batch: `words` (n_words int32, host memory, copied into
// the launch's parameter block) is the chunk table of FoldParams for
// n_tiles tiles and n_chunks chunks; bits rows `bits_ld` and accumulator rows
// `acc_ld` elements apart; the accumulator is folded in place.
int dvc_bf16_fold_chunks(const void* bits, void* acc, int64_t bits_ld, int64_t acc_ld, int64_t col0,
                         const int32_t* words, int n_words, int n_tiles, int n_chunks, void* stream) {
  if (bits == nullptr || acc == nullptr || words == nullptr || n_tiles < 1 || n_chunks < 1 ||
      n_words != 3 * n_tiles + 1 + 3 * n_chunks || n_words > kFoldWords || bits_ld < 0 || acc_ld < 0 ||
      col0 < 0)
    return cudaErrorInvalidValue;
  FoldParams p;
  p.bits = static_cast<const uint16_t*>(bits);
  p.acc = static_cast<float*>(acc);
  p.bits_ld = bits_ld;
  p.acc_ld = acc_ld;
  p.col0 = col0;
  p.n_tiles = n_tiles;
  p.n_chunks = n_chunks;
  for (int i = 0; i < n_words; ++i) p.words[i] = words[i];
  // The table's structure: chunk ranges in order and covering every chunk,
  // each chunk within its tile's columns.
  const int32_t* ptr = p.words + 2 * n_tiles;
  const int32_t* len = p.words + 3 * n_tiles + 1 + 2 * n_chunks;
  if (ptr[0] != 0 || ptr[n_tiles] != n_chunks) return cudaErrorInvalidValue;
  for (int u = 0; u < n_tiles; ++u) {
    if (p.words[u] < 0 || p.words[n_tiles + u] < 0 || ptr[u] > ptr[u + 1]) return cudaErrorInvalidValue;
    for (int j = ptr[u]; j < ptr[u + 1]; ++j) {
      if (p.words[3 * n_tiles + 1 + j] < 0 || len[j] < 0 || len[j] > p.words[n_tiles + u])
        return cudaErrorInvalidValue;
    }
  }
  return launch_fold(p, fold_vectorizable(p), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
