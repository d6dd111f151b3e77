// Ring reduce-scatter fold (K6) and ring all-gather (K7) for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of distributedvolunteercomputing_tpu/ops/
// mesh_collective.py: _ring_fold_kernel (K6: decode the staged bf16 wire
// chunks, fold w * widen(bits) by tile, forward the partial around the ring,
// add the resident accumulator shard on the last step) and _ring_ag_kernel
// (K7: ring all-gather of the element-split accumulator). On the TPU one
// pallas_call ran the whole ring as its grid, with remote DMAs and
// semaphores between chips; the compiled lowering fell back to XLA whenever
// its working set passed a 10 MiB VMEM cap, which the flagship buffer always
// did. These kernels take every size.
//
// Both have two designs, and the caller (ops/mesh_collective.py) picks one
// from where the ranks live, never from a failure:
//
//  - One card holds every rank (at most kFoldMaxRanks): the ring is a sum
//    order, not a transport, so nothing travels. K6 is one launch per ring
//    group of a flush (card_ring_fold_kernel) and K7 one launch per result
//    (card_ring_allgather_kernel), on the caller's stream, with every rank's
//    pointers in the parameter block.
//  - The ranks span cards: the stepwise design. K6 is one launch per card
//    per ring step (ring_fold_kernel, grid.y the card's ranks), each step
//    writing a partial slot that the right neighbour's next step reads; K7
//    is one launch per rank per hop (ring_allgather_kernel). The caller
//    orders the steps with CUDA events between the cards' streams. Data
//    moves by pull: a rank reads its left neighbour's buffers through their
//    device pointers, peer memory over NVLink (after dvc_enable_peer_access).
//    Nothing spins on a flag and nothing is staged through the host.
//
// K6's function, for every shard b and every distinct tile u of the flush
// (a "slot"): p_d = 0, then p_d = p_d + w_i * widen(bits_i) over rank d's
// chunks i of tile u in staging order, over the columns
// [b * shard, (b + 1) * shard); v = p_{b+1}, then v = v + p_{b+2}, ...,
// v = v + p_b (ranks mod nd); acc_b[tile_u] = acc_b[tile_u] + v. Multiply and
// add are rounded separately (__fmul_rn / __fadd_rn: no FMA contraction), so
// both designs are bit-equal to ring_fold_plain.
//
//  - card_ring_fold_kernel: block (x, u, b) of a (column groups, slots,
//    shards) grid; a thread owns 8 columns of slot u in shard b. It loads
//    the accumulator row's 8 lanes, then walks the slot's chunks in the
//    ring's order (ranks b + 1, ..., b, each rank's chunks in staging order),
//    issuing up to kFoldBatch 16-byte loads of bits before it folds them,
//    keeps every rank's partial and the running v in registers, and writes
//    the accumulator once. A flagship flush (16 chunks of 1 MiB over ~13
//    tiles) moves its bound's bytes: the bits once, the touched accumulator
//    rows read and written once; no partial slot exists.
//  - ring_fold_kernel (rank d, step s, shard b = (d - s - 1) mod nd): p over
//    the rank's own chunks, v = recv + p (recv: the left neighbour's partial
//    of step s - 1; none at step 0); non-last steps write v to the rank's
//    partial slot, the last step (b = d) writes acc[tile_u] + v. The partial
//    covers the flush's distinct tiles only, and the caller keeps the slots
//    across flushes. Each step adds a partial written and read through
//    device (or peer) memory: 2 (nd - 1) / nd extra passes per element.
//  - A flush whose metadata passes kFoldMetaWords is split by the caller
//    into groups of whole slots, each a ring of its own: every tile's sum
//    keeps its order.
//
// K7's function: every rank's [n_tiles, nd * shard] copy of the flat
// accumulator, shard b in columns [b * shard, (b + 1) * shard) of every row.
//
//  - card_ring_allgather_kernel: block (x, row, b); a thread loads
//    kUnroll 16-byte groups of shard b's row (all issued before any store)
//    and stores each into block b of all nd copies with evict-first stores.
//    Each shard is read once and each copy written once: the bound's bytes.
//  - ring_allgather_kernel (rank d, hop s): copy block (d - s - 1) mod nd
//    from the left neighbour (from its shard at hop 0, when the rank's own
//    shard is copied in the same launch). Every shard is read nd times.
//
// What bounds them on an H100: bytes (a few operations per byte moved). A
// flush of k chunks over U distinct tiles must read the k * tile_elems bf16
// bits once and read and write the U touched accumulator rows; K7 reads each
// shard once and writes nd full copies. The one-card designs move exactly
// that, 16 bytes a load, neighbouring threads on neighbouring addresses,
// streaming cache hints (__ldcs / __stcs: no byte is read twice), grids that
// cover the data in one pass, no shared memory (lanes are independent). A
// scalar path of the same shape takes a width or a pointer that is not
// 16-byte aligned. experiments/torch_ring_variants.py times them against the
// stepwise designs on one card and against a TMA bulk-copy K7
// (experiments/torch_ring_variants.cu) (PERF.md).
//
// Plain C interface (bound with ctypes); each entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

constexpr int kFoldMaxRanks = 8;      // ranks per launch (the stepwise grid.y, the one-card grid.z)
constexpr int kFoldMetaWords = 896;  // metadata words per launch: the block stays under 4 KB

// One rank's ring step (the one-card kernel reads bits, dst = the
// accumulator shard, meta and k).
struct FoldRank {
  const uint16_t* bits;  // own chunks [k, tile_elems]
  const float* recv;     // left neighbour's partial [n_slots, shard]; null at step 0
  float* dst;            // own partial [n_slots, shard], or the accumulator shard on the last step
  int64_t col0;          // b * shard
  int32_t meta;          // offset of the rank's slot_ptr in FoldParams::meta
  int32_t k;             // the rank's chunks in this launch
  int32_t last;
};

// meta (int32): row [n_slots] (slot u's tile: its accumulator row), then
// per rank at rank.meta: slot_ptr [n_slots + 1] | chunk [k] | weight bits
// [k]. The rank's chunks of slot u are positions slot_ptr[u] ..
// slot_ptr[u + 1] in staging order; position j folds bits row chunk[j] with
// weight[j].
struct FoldParams {
  int64_t shard;
  int64_t tile_elems;
  int32_t n_slots;
  int32_t n_ranks;
  FoldRank rank[kFoldMaxRanks];
  int32_t meta[kFoldMetaWords];
};
static_assert(sizeof(FoldParams) <= 4096, "K6's parameter block must stay under 4 KB");

template <int kVec>
__global__ void __launch_bounds__(kThreads) ring_fold_kernel(const __grid_constant__ FoldParams a) {
  const FoldRank& rk = a.rank[blockIdx.y];
  const int32_t* row = a.meta;
  const int32_t* slot_ptr = a.meta + rk.meta;
  const int32_t* chunk = slot_ptr + a.n_slots + 1;
  const int32_t* wbits = chunk + rk.k;
  const int64_t groups = a.shard / kVec;
  const int64_t total = groups * a.n_slots;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; item < total;
       item += stride) {
    const int u = static_cast<int>(item / groups);
    const int64_t c = (item - static_cast<int64_t>(u) * groups) * kVec;
    float p[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = 0.0f;
    const int j1 = slot_ptr[u + 1];
    for (int j = slot_ptr[u]; j < j1; ++j) {
      const float w = __int_as_float(wbits[j]);
      const uint16_t* x = rk.bits + static_cast<int64_t>(chunk[j]) * a.tile_elems + rk.col0 + c;
      if constexpr (kVec == 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(x);
        p[0] = axpy(p[0], w, v.x & 0xffffu);
        p[1] = axpy(p[1], w, v.x >> 16);
        p[2] = axpy(p[2], w, v.y & 0xffffu);
        p[3] = axpy(p[3], w, v.y >> 16);
        p[4] = axpy(p[4], w, v.z & 0xffffu);
        p[5] = axpy(p[5], w, v.z >> 16);
        p[6] = axpy(p[6], w, v.w & 0xffffu);
        p[7] = axpy(p[7], w, v.w >> 16);
      } else {
        p[0] = axpy(p[0], w, x[0]);
      }
    }
    if (rk.recv != nullptr) {
      const float* r = rk.recv + static_cast<int64_t>(u) * a.shard + c;
      if constexpr (kVec == 8) {
        const float4 r0 = *reinterpret_cast<const float4*>(r);
        const float4 r1 = *reinterpret_cast<const float4*>(r + 4);
        p[0] = __fadd_rn(r0.x, p[0]);
        p[1] = __fadd_rn(r0.y, p[1]);
        p[2] = __fadd_rn(r0.z, p[2]);
        p[3] = __fadd_rn(r0.w, p[3]);
        p[4] = __fadd_rn(r1.x, p[4]);
        p[5] = __fadd_rn(r1.y, p[5]);
        p[6] = __fadd_rn(r1.z, p[6]);
        p[7] = __fadd_rn(r1.w, p[7]);
      } else {
        p[0] = __fadd_rn(r[0], p[0]);
      }
    }
    float* out = rk.dst + static_cast<int64_t>(rk.last ? row[u] : u) * a.shard + c;
    if (rk.last) {
      if constexpr (kVec == 8) {
        const float4 a0 = *reinterpret_cast<const float4*>(out);
        const float4 a1 = *reinterpret_cast<const float4*>(out + 4);
        p[0] = __fadd_rn(a0.x, p[0]);
        p[1] = __fadd_rn(a0.y, p[1]);
        p[2] = __fadd_rn(a0.z, p[2]);
        p[3] = __fadd_rn(a0.w, p[3]);
        p[4] = __fadd_rn(a1.x, p[4]);
        p[5] = __fadd_rn(a1.y, p[5]);
        p[6] = __fadd_rn(a1.z, p[6]);
        p[7] = __fadd_rn(a1.w, p[7]);
      } else {
        p[0] = __fadd_rn(out[0], p[0]);
      }
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<float4*>(out) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(out + 4) = make_float4(p[4], p[5], p[6], p[7]);
    } else {
      out[0] = p[0];
    }
  }
}

// One block copy of K7: [rows, cols] from src (row stride src_ld) to dst
// (row stride dst_ld).
struct CopyArgs {
  const float* src;
  float* dst;
  int64_t src_ld;
  int vec;  // 16-byte loads and stores for full groups of 4 columns
};

__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(CopyArgs c0, CopyArgs c1, int64_t rows, int64_t cols, int64_t dst_ld) {
  const CopyArgs c = blockIdx.y == 0 ? c0 : c1;
  const int64_t groups = (cols + 3) / 4;  // the last group of a row may be short: scalar
  const int64_t total = rows * groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; item < total;
       item += stride) {
    const int64_t r = item / groups;
    const int64_t col = (item - r * groups) * 4;
    const float* s = c.src + r * c.src_ld + col;
    float* d = c.dst + r * dst_ld + col;
    if (c.vec && col + 4 <= cols) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      const int64_t n = cols - col < 4 ? cols - col : 4;
      for (int64_t e = 0; e < n; ++e) d[e] = s[e];
    }
  }
}

// --- one card holds every rank ------------------------------------------------

constexpr int kFoldBatch = 4;  // K6: chunk loads a thread issues before it folds them
constexpr int kUnroll = 4;     // K7: 16-byte groups a thread loads before it stores them

// kVec lanes of bf16 bits: one 16-byte load of 8 lanes, or one lane.
template <int kVec>
struct Bits;

template <>
struct Bits<8> {
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) { v = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ uint32_t lane(int e) const {
    const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return e & 1 ? w >> 16 : w & 0xffffu;
  }
};

template <>
struct Bits<1> {
  uint32_t v;
  __device__ __forceinline__ void load(const uint16_t* p) { v = __ldcs(p); }
  __device__ __forceinline__ uint32_t lane(int) const { return v; }
};

template <int kVec>
__device__ __forceinline__ void load_lanes(const float* p, float (&x)[kVec]) {
  if constexpr (kVec == 8) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p + 4));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_lanes(float* p, const float (&x)[kVec]) {
  if constexpr (kVec == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p + 4), make_float4(x[4], x[5], x[6], x[7]));
  } else {
    __stcs(p, x[0]);
  }
}

// The chunks of slot u that fold into shard b, in the ring's order: ranks
// b + 1, ..., b (mod nd), each rank's chunks of the slot in staging order.
// Every thread of a block walks the same positions (uniform reads of the
// parameter block).
struct RingWalk {
  const FoldParams& a;
  int u, step, r, j, end;  // step: ring position of rank r (0 for rank b + 1)

  __device__ __forceinline__ RingWalk(const FoldParams& a, int u, int b) : a(a), u(u), step(0) {
    r = b + 1 == a.n_ranks ? 0 : b + 1;
    open();
  }
  __device__ __forceinline__ void open() {
    const int32_t* slot_ptr = a.meta + a.rank[r].meta;
    j = slot_ptr[u];
    end = slot_ptr[u + 1];
  }
  // The next chunk: its ring position, bits row and weight; false past the last.
  __device__ __forceinline__ bool next(int* at, const uint16_t** row, float* w) {
    while (j == end) {
      if (step == a.n_ranks - 1) return false;
      ++step;
      r = r + 1 == a.n_ranks ? 0 : r + 1;
      open();
    }
    const FoldRank& rk = a.rank[r];
    const int32_t* chunk = a.meta + rk.meta + a.n_slots + 1;
    *at = step;
    *row = rk.bits + static_cast<int64_t>(chunk[j]) * a.tile_elems;
    *w = __int_as_float(chunk[rk.k + j]);
    ++j;
    return true;
  }
};

// K6 on one card: block (x, u, b) folds columns [x * kThreads * kVec, ...)
// of slot u in shard b; a.rank[d].dst is rank d's accumulator shard.
template <int kVec>
__global__ void __launch_bounds__(kThreads) card_ring_fold_kernel(const __grid_constant__ FoldParams a) {
  const int u = blockIdx.y, b = blockIdx.z;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= a.shard / kVec) return;
  const int64_t col = b * a.shard + g * kVec;  // in a bits row
  float* dst = a.rank[b].dst + static_cast<int64_t>(a.meta[u]) * a.shard + g * kVec;
  float acc[kVec], p[kVec], v[kVec];
  load_lanes<kVec>(dst, acc);
#pragma unroll
  for (int e = 0; e < kVec; ++e) p[e] = v[e] = 0.0f;
  int closed = 0;  // ring positions whose partial is in v
  auto close = [&]() {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[e] = closed == 0 ? p[e] : __fadd_rn(v[e], p[e]);
      p[e] = 0.0f;
    }
    ++closed;
  };
  RingWalk walk(a, u, b);
  for (;;) {
    Bits<kVec> x[kFoldBatch];
    int at[kFoldBatch];
    float w[kFoldBatch];
    int n = 0;
#pragma unroll
    for (int t = 0; t < kFoldBatch; ++t) {
      const uint16_t* row;
      if (n == t && walk.next(&at[t], &row, &w[t])) {
        x[t].load(row + col);
        n = t + 1;
      }
    }
#pragma unroll
    for (int t = 0; t < kFoldBatch; ++t) {
      if (t < n) {
        while (closed < at[t]) close();
#pragma unroll
        for (int e = 0; e < kVec; ++e) p[e] = axpy(p[e], w[t], x[t].lane(e));
      }
    }
    if (n < kFoldBatch) break;
  }
  while (closed < a.n_ranks) close();
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  store_lanes<kVec>(dst, acc);
}

struct GatherParams {
  const float* src[kFoldMaxRanks];  // shard b: [rows, shard]
  float* dst[kFoldMaxRanks];        // rank d's copy: [rows, nd * shard]
  int64_t rows;
  int64_t shard;
  int32_t nd;
};

// K7 on one card: block (x, y, b) copies groups [x * kThreads * kUnroll, ...)
// of shard b's rows y, y + gridDim.y, ... into block b of every copy.
template <int kVec>
__global__ void __launch_bounds__(kThreads) card_ring_allgather_kernel(const __grid_constant__ GatherParams a) {
  using V = typename std::conditional<kVec == 4, float4, float>::type;
  const int b = blockIdx.z;
  const int64_t groups = a.shard / kVec, width = a.nd * a.shard;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  for (int64_t row = blockIdx.y; row < a.rows; row += gridDim.y) {
    const V* src = reinterpret_cast<const V*>(a.src[b] + row * a.shard);
    V x[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int64_t g = g0 + t * kThreads;
      if (g < groups) x[t] = __ldcs(src + g);
    }
    for (int d = 0; d < a.nd; ++d) {
      V* out = reinterpret_cast<V*>(a.dst[d] + row * width + b * a.shard);
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const int64_t g = g0 + t * kThreads;
        if (g < groups) __stcs(out + g, x[t]);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Make `device` current for a launch; `prev` receives the device to restore.
cudaError_t enter_device(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t leave_device(int device, int prev, cudaError_t err) {
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return err;
}

// Enough blocks to fill every SM of `dev` (8 blocks of 256 threads each,
// shared by the `ways` rows of the grid), fewer when the work is smaller;
// the grid-stride loop covers the rest.
cudaError_t grid_for(int dev, int64_t items, int ways, int* blocks) {
  static int cached_sms[64] = {};  // per device: the attribute query is not free on every launch
  int sms = dev >= 0 && dev < 64 ? cached_sms[dev] : 0;
  if (sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) cached_sms[dev] = sms;
  }
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = (static_cast<int64_t>(sms) * 8 + ways - 1) / ways;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K6 ring step `step` of the n_ranks ranks of card `device`: one launch on
// `stream` (a stream of that card); the caller orders the steps (events
// between cards). ranks: n_ranks records of 9 int64 (bits, acc, own slot 0,
// own slot 1, left neighbour's slot 0 and 1, rank index, meta offset, k);
// meta: meta_words int32 (see FoldParams). Both are host memory, copied
// into the launch's parameter block.
int dvc_ring_fold(const int64_t* ranks, int n_ranks, int nd, int step, const int32_t* meta, int meta_words,
                  int n_slots, int64_t shard, int64_t tile_elems, int device, void* stream) {
  if (shard <= 0 || n_slots <= 0 || n_ranks < 1 || n_ranks > kFoldMaxRanks || nd < 2 || step < 0 || step >= nd ||
      meta_words < n_slots || meta_words > kFoldMetaWords || ranks == nullptr || meta == nullptr)
    return cudaErrorInvalidValue;
  FoldParams a;
  a.shard = shard;
  a.tile_elems = tile_elems;
  a.n_slots = n_slots;
  a.n_ranks = n_ranks;
  for (int i = 0; i < meta_words; ++i) a.meta[i] = meta[i];
  bool vec = shard % 8 == 0 && tile_elems % 8 == 0;
  for (int j = 0; j < n_ranks; ++j) {
    const int64_t* r = ranks + 9 * j;
    const int32_t off = static_cast<int32_t>(r[7]), k = static_cast<int32_t>(r[8]);
    if (r[1] == 0 || r[2] == 0 || r[3] == 0 || r[4] == 0 || r[5] == 0 || r[6] < 0 || r[6] >= nd ||
        off < n_slots || k < 0 || off + n_slots + 1 + 2 * k > meta_words || (k > 0 && r[0] == 0))
      return cudaErrorInvalidValue;
    for (int e = 0; e < 6; ++e) vec = vec && aligned16(reinterpret_cast<const void*>(r[e]));
    a.rank[j].bits = reinterpret_cast<const uint16_t*>(r[0]);
    a.rank[j].meta = off;
    a.rank[j].k = k;
  }
  int prev = 0;
  cudaError_t err = enter_device(device, &prev);
  int blocks = 0;
  if (err == cudaSuccess) err = grid_for(device, n_slots * (vec ? shard / 8 : shard), n_ranks, &blocks);
  const dim3 grid(blocks, n_ranks);
  auto st = static_cast<cudaStream_t>(stream);
  const int s = step;
  const bool last = s == nd - 1;
  for (int j = 0; j < n_ranks; ++j) {  // rank d at step s folds shard (d - s - 1) mod nd
    const int64_t* r = ranks + 9 * j;
    FoldRank& f = a.rank[j];
    f.recv = s > 0 ? reinterpret_cast<const float*>(r[4 + (s - 1) % 2]) : nullptr;
    f.dst = reinterpret_cast<float*>(last ? r[1] : r[2 + s % 2]);
    f.col0 = ((r[6] - s - 1) % nd + nd) % nd * shard;
    f.last = last;
  }
  if (err == cudaSuccess) {
    if (vec) {
      ring_fold_kernel<8><<<grid, kThreads, 0, st>>>(a);
    } else {
      ring_fold_kernel<1><<<grid, kThreads, 0, st>>>(a);
    }
    err = cudaGetLastError();
  }
  return leave_device(device, prev, err);
}

// K6 on card `device` holding all nd ranks: one launch folds one ring group
// of whole slots, on `stream`. ranks: nd records of 4 int64 (bits, acc,
// meta offset, k), rank d's own chunks [k_d rows, tile_elems] and its
// accumulator shard [n_tiles, shard]; meta: meta_words int32 (FoldParams).
// Both are host memory, copied into the launch's parameter block.
int dvc_ring_fold_card(const int64_t* ranks, int nd, const int32_t* meta, int meta_words, int n_slots,
                       int64_t shard, int64_t tile_elems, int64_t n_tiles, int device, void* stream) {
  if (shard <= 0 || n_slots <= 0 || n_slots > 65535 || nd < 2 || nd > kFoldMaxRanks || tile_elems < nd * shard ||
      meta_words < n_slots || meta_words > kFoldMetaWords || ranks == nullptr || meta == nullptr)
    return cudaErrorInvalidValue;
  FoldParams a;
  a.shard = shard;
  a.tile_elems = tile_elems;
  a.n_slots = n_slots;
  a.n_ranks = nd;
  for (int i = 0; i < meta_words; ++i) a.meta[i] = meta[i];
  for (int u = 0; u < n_slots; ++u) {
    if (a.meta[u] < 0 || a.meta[u] >= n_tiles) return cudaErrorInvalidValue;
  }
  bool vec = shard % 8 == 0 && tile_elems % 8 == 0;
  for (int d = 0; d < nd; ++d) {
    const int64_t* r = ranks + 4 * d;
    const int32_t off = static_cast<int32_t>(r[2]), k = static_cast<int32_t>(r[3]);
    if (r[1] == 0 || off < n_slots || k < 0 || off + n_slots + 1 + 2 * k > meta_words || (k > 0 && r[0] == 0))
      return cudaErrorInvalidValue;
    // The slot ranges: in order, covering the rank's k positions.
    const int32_t* slot_ptr = a.meta + off;
    if (slot_ptr[0] != 0 || slot_ptr[n_slots] != k) return cudaErrorInvalidValue;
    for (int u = 0; u < n_slots; ++u) {
      if (slot_ptr[u] > slot_ptr[u + 1]) return cudaErrorInvalidValue;
    }
    for (int j = 0; j < k; ++j) {
      if (slot_ptr[n_slots + 1 + j] < 0) return cudaErrorInvalidValue;
    }
    vec = vec && aligned16(reinterpret_cast<const void*>(r[0])) && aligned16(reinterpret_cast<const void*>(r[1]));
    a.rank[d] = FoldRank{reinterpret_cast<const uint16_t*>(r[0]), nullptr, reinterpret_cast<float*>(r[1]), 0, off, k,
                         1};
  }
  int prev = 0;
  cudaError_t err = enter_device(device, &prev);
  if (err == cudaSuccess) {
    const int64_t groups = vec ? shard / 8 : shard;
    const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads), n_slots, nd);
    if (vec) {
      card_ring_fold_kernel<8><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    } else {
      card_ring_fold_kernel<1><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    }
    err = cudaGetLastError();
  }
  return leave_device(device, prev, err);
}

// K7 on card `device` holding all nd ranks: one launch writes every rank's
// full copy, on `stream`. ptrs: nd shard pointers ([rows, shard] each), then
// nd copy pointers ([rows, nd * shard] each).
int dvc_ring_allgather_card(const int64_t* ptrs, int nd, int64_t rows, int64_t shard, int device, void* stream) {
  if (ptrs == nullptr || nd < 2 || nd > kFoldMaxRanks || rows <= 0 || shard <= 0) return cudaErrorInvalidValue;
  GatherParams a;
  a.rows = rows;
  a.shard = shard;
  a.nd = nd;
  bool vec = shard % 4 == 0;
  for (int d = 0; d < nd; ++d) {
    if (ptrs[d] == 0 || ptrs[nd + d] == 0) return cudaErrorInvalidValue;
    a.src[d] = reinterpret_cast<const float*>(ptrs[d]);
    a.dst[d] = reinterpret_cast<float*>(ptrs[nd + d]);
    vec = vec && aligned16(a.src[d]) && aligned16(a.dst[d]);
  }
  int prev = 0;
  cudaError_t err = enter_device(device, &prev);
  if (err == cudaSuccess) {
    const int64_t groups = vec ? shard / 4 : shard;
    const dim3 grid(static_cast<unsigned>((groups + kThreads * kUnroll - 1) / (kThreads * kUnroll)),
                    static_cast<unsigned>(rows < 65535 ? rows : 65535), nd);
    if (vec) {
      card_ring_allgather_kernel<4><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    } else {
      card_ring_allgather_kernel<1><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    }
    err = cudaGetLastError();
  }
  return leave_device(device, prev, err);
}

// (src0, dst0, src0_ld) is the block from the left neighbour; (src1, dst1,
// src1_ld), when src1 is not null, the rank's own shard (step 0 only).
int dvc_ring_allgather(const void* src0, void* dst0, int64_t src0_ld, const void* src1, void* dst1,
                       int64_t src1_ld, int64_t rows, int64_t cols, int64_t dst_ld, void* stream) {
  if (rows <= 0 || cols <= 0 || src0 == nullptr || dst0 == nullptr) return cudaErrorInvalidValue;
  const bool two = src1 != nullptr;
  if (two && dst1 == nullptr) return cudaErrorInvalidValue;
  const bool ld_ok = dst_ld % 4 == 0;
  CopyArgs c0{static_cast<const float*>(src0), static_cast<float*>(dst0), src0_ld,
              ld_ok && src0_ld % 4 == 0 && aligned16(src0) && aligned16(dst0)};
  CopyArgs c1{static_cast<const float*>(src1), static_cast<float*>(dst1), src1_ld,
              ld_ok && src1_ld % 4 == 0 && aligned16(src1) && aligned16(dst1)};
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = grid_for(dev, rows * ((cols + 3) / 4), 1, &blocks);
  if (err != cudaSuccess) return err;
  dim3 grid(blocks, two ? 2 : 1);
  ring_allgather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c0, c1, rows, cols, dst_ld);
  return cudaGetLastError();
}

// Let ``dev`` read ``peer``'s memory (K6/K7 pull from the left neighbour).
// Fails when the two cards cannot reach each other: nothing is staged
// through the host instead.
int dvc_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return err;
  if (!can) return cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free "already enabled" status
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

}  // extern "C"
