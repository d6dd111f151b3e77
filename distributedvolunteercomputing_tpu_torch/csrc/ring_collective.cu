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
// One launch is one ring step of one rank, on that rank's CUDA stream. The
// caller (ops/mesh_collective.py) orders the launches with CUDA events: step
// s of rank d waits for step s - 1 of its left neighbour (the partial it
// reads) and, from step 2 on, for step s - 1 of its right neighbour (which
// has then finished reading the slot that step s overwrites: the TPU
// kernel's capacity semaphore). Nothing spins on a flag, so ranks that share
// a card cannot deadlock, whichever of their kernels the card runs first.
// Data moves by pull: a rank reads its left neighbour's buffers through
// their device pointers, the same address space on one card and peer memory
// over NVLink on two (after dvc_enable_peer_access). Nothing is staged
// through the host.
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
//    the compact one is ~17 MB, and the function is the same.
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
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

// meta (int32): slot_ptr [n_slots + 1] | chunk [n_chunks] | row [n_slots] | weight bits [n_chunks].
// The rank's chunks of slot u are chunk[slot_ptr[u] .. slot_ptr[u + 1]), in
// staging order; row[u] is slot u's tile (its row of the accumulator).
struct FoldArgs {
  const uint16_t* bits;  // own chunks [n_chunks, tile_elems]
  const int32_t* meta;
  const float* recv;     // left neighbour's partial [n_slots, shard]; null at step 0
  float* dst;            // own partial [n_slots, shard], or the accumulator shard on the last step
  int64_t col0;          // b * shard
  int64_t shard;
  int64_t tile_elems;
  int n_slots;
  int n_chunks;
  int last;
};

template <int kVec>
__global__ void __launch_bounds__(kThreads) ring_fold_kernel(FoldArgs a) {
  const int32_t* slot_ptr = a.meta;
  const int32_t* chunk = slot_ptr + a.n_slots + 1;
  const int32_t* row = chunk + a.n_chunks;
  const float* ws = reinterpret_cast<const float*>(row + a.n_slots);
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
      const int i = chunk[j];
      const float w = ws[i];
      const uint16_t* x = a.bits + static_cast<int64_t>(i) * a.tile_elems + a.col0 + c;
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
    if (a.recv != nullptr) {
      const float* r = a.recv + static_cast<int64_t>(u) * a.shard + c;
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
    float* out = a.dst + static_cast<int64_t>(a.last ? row[u] : u) * a.shard + c;
    if (a.last) {
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

// Enough blocks to fill every SM (8 blocks of 256 threads each), fewer when
// the work is smaller; the grid-stride loop covers the rest.
cudaError_t grid_for(int64_t items, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

}  // namespace

extern "C" {

int dvc_ring_fold(const void* bits, const void* meta, const void* recv, void* dst, int64_t col0, int64_t shard,
                  int64_t tile_elems, int n_slots, int n_chunks, int last, void* stream) {
  if (shard <= 0 || n_slots <= 0 || n_chunks < 0 || meta == nullptr || dst == nullptr) return cudaErrorInvalidValue;
  FoldArgs a{static_cast<const uint16_t*>(bits), static_cast<const int32_t*>(meta),
             static_cast<const float*>(recv), static_cast<float*>(dst), col0, shard, tile_elems,
             n_slots, n_chunks, last};
  const bool vec = shard % 8 == 0 && tile_elems % 8 == 0 && aligned16(bits) && aligned16(recv) && aligned16(dst);
  int blocks = 0;
  cudaError_t err = grid_for(n_slots * (vec ? shard / 8 : shard), &blocks);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    ring_fold_kernel<8><<<blocks, kThreads, 0, s>>>(a);
  } else {
    ring_fold_kernel<1><<<blocks, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
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
  int blocks = 0;
  cudaError_t err = grid_for(rows * ((cols + 3) / 4), &blocks);
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
