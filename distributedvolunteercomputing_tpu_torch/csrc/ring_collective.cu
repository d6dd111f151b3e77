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
// K6: one launch is one ring step of every rank on one card (grid.y = the
// card's ranks), on one stream of that card, its flush metadata passed by
// value in the kernel's parameter block: no device buffer, no host-to-device
// copy, no synchronisation per flush. One call from the host launches every
// step of a card that holds all the ranks. The caller (ops/mesh_collective.py)
// orders the steps: on one card, stream order alone gives "step s of rank d
// after step s - 1 of its left neighbour (the partial it reads)" and "after
// step s - 1 of its right neighbour (which has then finished reading the
// slot step s overwrites: the TPU kernel's capacity semaphore)"; between
// cards, CUDA events give them. K7: one launch is one hop of one rank, on
// that rank's stream, ordered by events. Nothing spins on a flag, so ranks
// that share a card cannot deadlock, whichever of their blocks the card
// runs first. Data moves by pull: a rank reads its left neighbour's buffers
// through their device pointers, the same address space on one card and
// peer memory over NVLink on two (after dvc_enable_peer_access). Nothing
// is staged through the host.
//
//  - K6, rank d, step s, shard b = (d - s - 1) mod nd: for each of the
//    flush's distinct tiles u, p = 0, then p = p + w_i * widen(bits_i) over
//    the rank's own chunks i of that tile in staging order, over the
//    columns [b * shard, (b + 1) * shard); v = recv + p (recv: the left
//    neighbour's partial of step s - 1; none at step 0); non-last steps
//    write v to the rank's partial slot, the last step (where b = d) writes
//    acc[tile_u] + v into the accumulator shard in place. Multiply and add
//    are rounded separately (__fmul_rn / __fadd_rn: no FMA contraction), so
//    the fold is bit-equal to ring_fold_plain.
//    The partial covers the flush's distinct tiles only (at most ~17 rows
//    for a 16 MiB flush of 1 MiB chunks), not all n_tiles rows as the TPU
//    kernel's scratch did: at gpt2_small and nd = 2 a full partial is
//    238 x 262,144 floats (250 MB) zeroed, written and read at every step;
//    the compact one is ~17 MB, and the function is the same. The caller
//    keeps the partial slots across flushes. A flush whose metadata passes
//    kFoldMetaWords is split by the caller into groups of whole slots, each
//    a ring of its own: every tile's sum keeps its order.
//  - K7, rank d, step s: copy block (d - s - 1) mod nd from the left
//    neighbour into the rank's full [n_tiles, nd * shard] result; at step 0
//    the block comes from the neighbour's accumulator shard, and the rank's
//    own shard is copied into its own block in the same launch. Each block
//    lands in columns [blk * shard, (blk + 1) * shard) of every row, so the
//    result is the flat accumulator with no transpose after it.
//
// What bounds them on an H100: bytes. A flush of k chunks over U distinct
// tiles must read the k * tile_elems bf16 bits once and read and write the
// U touched accumulator rows (2 + 8 B per element at U = k); the ring adds
// 2 (nd - 1) / nd partial passes per element on top, which on one card are
// device-memory traffic and across cards NVLink traffic. K7 reads each
// shard once and writes nd full copies. The design is the plain one for a
// streaming pass: a grid-stride loop, 8 columns per thread with 16-byte
// loads and stores of bits, partials and accumulator rows (4 floats for
// K7), a scalar path when a width or a pointer is not 16-byte aligned, no
// shared memory (lanes are independent).
//
// Plain C interface (bound with ctypes); each entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

constexpr int kFoldMaxRanks = 8;      // ranks per launch (grid.y)
constexpr int kFoldMetaWords = 896;  // metadata words per launch: the block stays under 4 KB

// One rank's ring step.
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

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

// K6 ring steps [step0, step1) of the n_ranks ranks of card `device`, one
// launch per step, on `stream` (a stream of that card): the whole ring in one
// call when the card holds every rank, one step per call when other cards'
// steps must be ordered by events in between. ranks: n_ranks records of 9
// int64 (bits, acc, own slot 0, own slot 1, left neighbour's slot 0 and 1,
// rank index, meta offset, k); meta: meta_words int32 (see FoldParams).
// Both are host memory, copied into each launch's parameter block.
int dvc_ring_fold(const int64_t* ranks, int n_ranks, int nd, int step0, int step1, const int32_t* meta,
                  int meta_words, int n_slots, int64_t shard, int64_t tile_elems, int device, void* stream) {
  if (shard <= 0 || n_slots <= 0 || n_ranks < 1 || n_ranks > kFoldMaxRanks || nd < 2 || step0 < 0 ||
      step1 > nd || step0 >= step1 || meta_words < n_slots || meta_words > kFoldMetaWords ||
      ranks == nullptr || meta == nullptr)
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
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  int blocks = 0;
  if (err == cudaSuccess) err = grid_for(device, n_slots * (vec ? shard / 8 : shard), n_ranks, &blocks);
  const dim3 grid(blocks, n_ranks);
  auto st = static_cast<cudaStream_t>(stream);
  for (int s = step0; s < step1 && err == cudaSuccess; ++s) {
    const bool last = s == nd - 1;
    for (int j = 0; j < n_ranks; ++j) {  // rank d at step s folds shard (d - s - 1) mod nd
      const int64_t* r = ranks + 9 * j;
      FoldRank& f = a.rank[j];
      f.recv = s > 0 ? reinterpret_cast<const float*>(r[4 + (s - 1) % 2]) : nullptr;
      f.dst = reinterpret_cast<float*>(last ? r[1] : r[2 + s % 2]);
      f.col0 = ((r[6] - s - 1) % nd + nd) % nd * shard;
      f.last = last;
    }
    if (vec) {
      ring_fold_kernel<8><<<grid, kThreads, 0, st>>>(a);
    } else {
      ring_fold_kernel<1><<<grid, kThreads, 0, st>>>(a);
    }
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return err;
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
