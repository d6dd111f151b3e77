// Codec kernel designs timed against csrc/bf16_codec.cu by
// experiments/torch_codec_variants.py (built there with nvcc into its own
// library; the port never loads it).
//
//  - parent_*: the first design of K4 and K5, as the port shipped it before
//    the redesign: a grid-stride loop of 8 elements per thread (two float4
//    loads, one uint4 store), 8 blocks of 256 threads per SM with the SM count
//    queried on every call, one K5 launch per chunk.
//  - tma_*: candidate (b) of the redesign. One persistent block per SM moves
//    the data with TMA 1-D bulk copies (cp.async.bulk) through a ring of
//    shared-memory stages, each completed on an mbarrier, issued by one
//    elected thread; the block's threads convert in shared memory and the
//    results go back to device memory as bulk stores (commit_group /
//    wait_group). K5's table is csrc/bf16_codec.cu's, by value. Both take
//    16-byte aligned pointers and widths that are multiples of 8 elements
//    only (bulk copies move multiples of 16 bytes); the script's cases are.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t x = __float_as_uint(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return ((x >> 16) & 0x8000u) | 0x7fc0u;
  return (x + 0x7fffu + ((x >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

// --- the parent design -------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kVec = 8;

template <bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    parent_encode_kernel(const float* __restrict__ x, uint16_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVectorized) {
    const int64_t nvec = n / kVec;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const float4 a = x4[2 * i];
      const float4 b = x4[2 * i + 1];
      uint4 r;
      r.x = bf16_bits(a.x) | (bf16_bits(a.y) << 16);
      r.y = bf16_bits(a.z) | (bf16_bits(a.w) << 16);
      r.z = bf16_bits(b.x) | (bf16_bits(b.y) << 16);
      r.w = bf16_bits(b.z) | (bf16_bits(b.w) << 16);
      o4[i] = r;
    }
    done = nvec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = static_cast<uint16_t>(bf16_bits(x[i]));
}

template <bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    parent_decode_axpy_kernel(const uint16_t* __restrict__ bits, const float* acc, float* out, float w,
                              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVectorized) {
    const int64_t nvec = n / kVec;
    const uint4* b4 = reinterpret_cast<const uint4*>(bits);
    const float4* a4 = reinterpret_cast<const float4*>(acc);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const uint4 b = b4[i];
      const float4 a = a4[2 * i];
      const float4 c = a4[2 * i + 1];
      float4 r, s;
      r.x = axpy(a.x, w, b.x & 0xffffu);
      r.y = axpy(a.y, w, b.x >> 16);
      r.z = axpy(a.z, w, b.y & 0xffffu);
      r.w = axpy(a.w, w, b.y >> 16);
      s.x = axpy(c.x, w, b.z & 0xffffu);
      s.y = axpy(c.y, w, b.z >> 16);
      s.z = axpy(c.z, w, b.w & 0xffffu);
      s.w = axpy(c.w, w, b.w >> 16);
      o4[2 * i] = r;
      o4[2 * i + 1] = s;
    }
    done = nvec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = axpy(acc[i], w, bits[i]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

cudaError_t parent_grid_for(int64_t n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n / kVec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// --- candidate (b): TMA bulk copies through shared-memory stages -------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Global -> shared, `bytes` (a multiple of 16) counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Shared -> global, then close the bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory visible to the bulk copies.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

constexpr int kTmaThreads = 256;
constexpr int kEncTile = 8192;  // floats per stage: 32 KB in, 16 KB out
constexpr int kEncStages = 4;   // 192 KB: one block per SM
constexpr int kEncSmem = kEncStages * kEncTile * 6 + kEncStages * 8;

// K4 (b): the block's tiles t = blockIdx.x + i * gridDim.x of kEncTile
// floats; thread 0 keeps kEncStages loads in flight; the rest of n after
// the last whole tile by plain loads.
__global__ void __launch_bounds__(kTmaThreads, 1)
    tma_encode_kernel(const float* __restrict__ x, uint16_t* __restrict__ out, int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* in = reinterpret_cast<float*>(smem);
  uint16_t* ob = reinterpret_cast<uint16_t*>(smem + kEncStages * kEncTile * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kEncStages * kEncTile * 6);
  const int tid = threadIdx.x;
  const int64_t tiles = n / kEncTile;
  const int64_t mine = blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (tid == 0) {
    for (int s = 0; s < kEncStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int64_t i) {
    const int s = static_cast<int>(i % kEncStages);
    const int64_t t = blockIdx.x + i * gridDim.x;
    bulk_load(smem_u32(in + s * kEncTile), x + t * kEncTile, kEncTile * 4, smem_u32(&full[s]));
  };
  if (tid == 0) {
    for (int64_t i = 0; i < mine && i < kEncStages; ++i) load(i);
  }
  for (int64_t i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kEncStages);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / kEncStages) & 1));
    if (tid == 0 && i >= kEncStages) bulk_wait_read<kEncStages - 1>();  // the store of i - kEncStages left ob[s]
    __syncthreads();
    const float4* src = reinterpret_cast<const float4*>(in + s * kEncTile);
    uint2* dst = reinterpret_cast<uint2*>(ob + s * kEncTile);
#pragma unroll 4
    for (int e = tid; e < kEncTile / 4; e += kTmaThreads) {
      const float4 v = src[e];
      dst[e] = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16), bf16_bits(v.z) | (bf16_bits(v.w) << 16));
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      const int64_t t = blockIdx.x + i * gridDim.x;
      bulk_store(out + t * kEncTile, smem_u32(ob + s * kEncTile), kEncTile * 2);
      if (i + kEncStages < mine) load(i + kEncStages);
    }
  }
  if (tid == 0) bulk_wait_all();
  for (int64_t e = tiles * kEncTile + static_cast<int64_t>(blockIdx.x) * kTmaThreads + tid; e < n;
       e += static_cast<int64_t>(gridDim.x) * kTmaThreads) {
    out[e] = static_cast<uint16_t>(bf16_bits(x[e]));
  }
}

// K5 (b), csrc/bf16_codec.cu's table. Work items are (tile u, column block
// cb) of kFoldCols columns; an item's loads are its accumulator slice then
// one bits slice per chunk of the tile (a chunk that ends before the block
// still takes its stage, completed by a plain arrival). Each thread keeps
// 16 accumulator columns in registers across the item's chunks; the result
// goes back through one of two output buffers by a bulk store.
constexpr int kFoldWords = 2032;
struct FoldParams {
  const uint16_t* bits;
  const float* src;
  float* dst;
  int64_t bits_ld;
  int64_t acc_ld;
  int64_t col0;
  int32_t n_tiles;
  int32_t n_chunks;
  int32_t words[kFoldWords];
};

constexpr int kFoldCols = 4096;           // columns per item: 16 KB of f32, 8 KB of bits
constexpr int kFoldStages = 8;            // 16 KB each
constexpr int kFoldStage = kFoldCols * 4;
constexpr int kFoldSmem = kFoldStages * kFoldStage + 2 * kFoldStage + kFoldStages * 8;
constexpr int kPer = kFoldCols / (4 * kTmaThreads);  // float4 groups per thread per item

struct Table {
  const FoldParams& p;
  __device__ int64_t row(int u) const { return p.words[u]; }
  __device__ int64_t cols(int u) const { return p.words[p.n_tiles + u]; }
  __device__ int first(int u) const { return p.words[2 * p.n_tiles + u]; }
  __device__ int last(int u) const { return p.words[2 * p.n_tiles + u + 1]; }
  __device__ int64_t chunk_row(int j) const { return p.words[3 * p.n_tiles + 1 + j]; }
  __device__ float weight(int j) const { return __int_as_float(p.words[3 * p.n_tiles + 1 + p.n_chunks + j]); }
  __device__ int64_t len(int j) const { return p.words[3 * p.n_tiles + 1 + 2 * p.n_chunks + j]; }
  // Item id -> (tile, column block), items numbered tile by tile.
  __device__ bool item(int64_t id, int* u, int64_t* cb) const {
    for (int t = 0; t < p.n_tiles; ++t) {
      const int64_t blocks = (cols(t) + kFoldCols - 1) / kFoldCols;
      if (id < blocks) {
        *u = t;
        *cb = id;
        return true;
      }
      id -= blocks;
    }
    return false;
  }
};

// Walks one block's loads in order: per item, part 0 the accumulator slice,
// part 1 + c the tile's chunk c.
struct Cursor {
  int64_t id;  // the block's item, as a global item id
  int part;
  int u;
  int64_t cb;
  bool live;
};

__device__ void cursor_start(const Table& tb, Cursor* c) {
  c->id = blockIdx.x;
  c->part = 0;
  c->live = tb.item(c->id, &c->u, &c->cb);
}

__device__ void cursor_next(const Table& tb, Cursor* c) {
  if (++c->part > tb.last(c->u) - tb.first(c->u)) {
    c->id += gridDim.x;
    c->part = 0;
    c->live = tb.item(c->id, &c->u, &c->cb);
  }
}

__device__ void fold_issue(const Table& tb, const Cursor& c, unsigned char* stages, uint64_t* full, int64_t seq) {
  const int s = static_cast<int>(seq % kFoldStages);
  const uint32_t dst = smem_u32(stages + s * kFoldStage), bar = smem_u32(&full[s]);
  const int64_t c0 = c.cb * kFoldCols;
  const int64_t width = tb.cols(c.u) - c0 < kFoldCols ? tb.cols(c.u) - c0 : kFoldCols;
  if (c.part == 0) {
    bulk_load(dst, tb.p.src + tb.row(c.u) * tb.p.acc_ld + c0, static_cast<uint32_t>(width * 4), bar);
    return;
  }
  const int j = tb.first(c.u) + c.part - 1;
  int64_t valid = tb.len(j) - c0;
  valid = valid < 0 ? 0 : (valid > width ? width : valid);
  if (valid == 0) {
    mbar_arrive(bar);
  } else {
    bulk_load(dst, tb.p.bits + tb.chunk_row(j) * tb.p.bits_ld + tb.p.col0 + c0, static_cast<uint32_t>(valid * 2),
              bar);
  }
}

__global__ void __launch_bounds__(kTmaThreads, 1) tma_fold_kernel(const __grid_constant__ FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;
  float* outb = reinterpret_cast<float*>(smem + kFoldStages * kFoldStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFoldStages * kFoldStage + 2 * kFoldStage);
  const Table tb{p};
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFoldStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Cursor issue, use;
  cursor_start(tb, &issue);
  cursor_start(tb, &use);
  int64_t issued = 0, used = 0, items = 0;
  if (tid == 0) {
    while (issue.live && issued < kFoldStages) {
      fold_issue(tb, issue, stages, full, issued++);
      cursor_next(tb, &issue);
    }
  }
  float4 a[kPer];
  while (use.live) {
    const int s = static_cast<int>(used % kFoldStages);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((used / kFoldStages) & 1));
    const int64_t c0 = use.cb * kFoldCols;
    const int64_t width = tb.cols(use.u) - c0 < kFoldCols ? tb.cols(use.u) - c0 : kFoldCols;
    if (use.part == 0) {
      const float4* src = reinterpret_cast<const float4*>(stages + s * kFoldStage);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int g = k * kTmaThreads + tid;
        if (4 * g < width) a[k] = src[g];
      }
    } else {
      const int j = tb.first(use.u) + use.part - 1;
      const float w = tb.weight(j);
      const int64_t valid = tb.len(j) - c0;
      const uint2* b = reinterpret_cast<const uint2*>(stages + s * kFoldStage);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int g = k * kTmaThreads + tid;
        const int64_t v = valid - 4 * g;
        if (4 * g < width && v > 0) {
          const uint2 x = b[g];
          a[k].x = axpy(a[k].x, w, x.x & 0xffffu);
          if (v > 1) a[k].y = axpy(a[k].y, w, x.x >> 16);
          if (v > 2) a[k].z = axpy(a[k].z, w, x.y & 0xffffu);
          if (v > 3) a[k].w = axpy(a[k].w, w, x.y >> 16);
        }
      }
    }
    const bool item_done = use.part == tb.last(use.u) - tb.first(use.u);
    float* ob = outb + (items % 2) * kFoldCols;
    if (item_done) {  // the accumulator slice back through out buffer items % 2
      if (tid == 0 && items >= 2) bulk_wait_read<1>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int g = k * kTmaThreads + tid;
        if (4 * g < width) reinterpret_cast<float4*>(ob)[g] = a[k];
      }
      fence_async_smem();
    }
    __syncthreads();  // stage s read by every thread
    if (tid == 0) {
      if (item_done) {
        bulk_store(p.dst + tb.row(use.u) * p.acc_ld + c0, smem_u32(ob), static_cast<uint32_t>(width * 4));
      }
      if (issue.live) {
        fold_issue(tb, issue, stages, full, issued++);
        cursor_next(tb, &issue);
      }
    }
    if (item_done) ++items;
    ++used;
    cursor_next(tb, &use);
  }
  if (tid == 0) bulk_wait_all();
}

}  // namespace

extern "C" {

int dvc_parent_encode(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = parent_grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<uint16_t*>(out);
  if (aligned16(x) && aligned16(out)) {
    parent_encode_kernel<true><<<blocks, kThreads, 0, s>>>(xf, o, n);
  } else {
    parent_encode_kernel<false><<<blocks, kThreads, 0, s>>>(xf, o, n);
  }
  return cudaGetLastError();
}

int dvc_parent_decode_axpy(const void* bits, const void* acc, void* out, float w, int64_t n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = parent_grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint16_t*>(bits);
  auto a = static_cast<const float*>(acc);
  auto o = static_cast<float*>(out);
  if (aligned16(bits) && aligned16(acc) && aligned16(out)) {
    parent_decode_axpy_kernel<true><<<blocks, kThreads, 0, s>>>(b, a, o, w, n);
  } else {
    parent_decode_axpy_kernel<false><<<blocks, kThreads, 0, s>>>(b, a, o, w, n);
  }
  return cudaGetLastError();
}

int dvc_tma_encode(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0 || !aligned16(x) || !aligned16(out)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tma_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kEncSmem);
  if (err != cudaSuccess) return err;
  tma_encode_kernel<<<sms, kTmaThreads, kEncSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(out), n);
  return cudaGetLastError();
}

int dvc_tma_fold_chunks(const void* bits, void* acc, int64_t bits_ld, int64_t acc_ld, int64_t col0,
                        const int32_t* words, int n_words, int n_tiles, int n_chunks, void* stream) {
  if (bits == nullptr || acc == nullptr || words == nullptr || n_tiles < 1 || n_chunks < 1 ||
      n_words != 3 * n_tiles + 1 + 3 * n_chunks || n_words > kFoldWords || !aligned16(bits) || !aligned16(acc) ||
      bits_ld % 8 || acc_ld % 4 || col0 % 8)
    return cudaErrorInvalidValue;
  FoldParams p;
  p.bits = static_cast<const uint16_t*>(bits);
  p.src = static_cast<const float*>(acc);
  p.dst = static_cast<float*>(acc);
  p.bits_ld = bits_ld;
  p.acc_ld = acc_ld;
  p.col0 = col0;
  p.n_tiles = n_tiles;
  p.n_chunks = n_chunks;
  memcpy(p.words, words, sizeof(int32_t) * n_words);
  for (int u = 0; u < n_tiles; ++u) {  // bulk copies move multiples of 16 bytes
    if (p.words[n_tiles + u] % 8) return cudaErrorInvalidValue;
  }
  for (int j = 0; j < n_chunks; ++j) {
    if (p.words[3 * n_tiles + 1 + 2 * n_chunks + j] % 8) return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tma_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFoldSmem);
  if (err != cudaSuccess) return err;
  tma_fold_kernel<<<sms, kTmaThreads, kFoldSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
