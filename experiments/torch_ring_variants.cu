// A ring all-gather (K7) design timed against csrc/ring_collective.cu's by
// experiments/torch_ring_variants.py and chip_smoke.py (built there with nvcc
// into its own library; the port never loads it).
//
//  - tma_allgather_kernel: the alternative to the one-card
//    card_ring_allgather_kernel. One persistent block of one warp (three a
//    SM) walks items of kSeg floats of one shard's row; its lane 0 moves each
//    item with TMA 1-D bulk copies (cp.async.bulk): one load into a ring of
//    kStages shared-memory stages, completed on an mbarrier, then nd bulk
//    stores from that stage into block b of every rank's copy, committed as
//    one bulk group. A stage is reloaded once its stores have read it
//    (cp.async.bulk.wait_group.read). No register holds the data. Each shard
//    is read once and each copy written once, as in the kept design. It
//    takes 16-byte aligned pointers and shard widths that are multiples of 4
//    floats only (bulk copies move multiples of 16 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kSeg = 4096;   // floats per item and stage: 16 KB
constexpr int kStages = 4;   // 64 KB a block: three blocks a SM
constexpr int kBlocksPerSm = 3;
constexpr int kSmem = kStages * kSeg * 4 + kStages * 8;

struct GatherParams {
  const float* src[kMaxRanks];  // shard b: [rows, shard]
  float* dst[kMaxRanks];        // rank d's copy: [rows, nd * shard]
  int64_t rows;
  int64_t shard;
  int32_t nd;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Shared -> global, in the open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(32) tma_allgather_kernel(const __grid_constant__ GatherParams a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  float* stage = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kSeg * 4);
  const int64_t segs = (a.shard + kSeg - 1) / kSeg, width = a.nd * a.shard;
  const int64_t items = segs * a.rows * a.nd;
  const int64_t mine = blockIdx.x < items ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // Item t: segment t % segs of row (t / segs) % rows of shard t / (segs * rows).
  auto where = [&](int64_t i, int* b, int64_t* off, uint32_t* bytes) {
    const int64_t t = blockIdx.x + i * gridDim.x;
    const int64_t seg = t % segs, rest = t / segs;
    const int64_t row = rest % a.rows;
    *b = static_cast<int>(rest / a.rows);
    const int64_t c0 = seg * kSeg;
    *off = row * a.shard + c0;
    *bytes = static_cast<uint32_t>((a.shard - c0 < kSeg ? a.shard - c0 : kSeg) * 4);
    return row * width + *b * a.shard + c0;
  };
  auto load = [&](int64_t i) {
    int b;
    int64_t off;
    uint32_t bytes;
    where(i, &b, &off, &bytes);
    const int s = static_cast<int>(i % kStages);
    bulk_load(smem_u32(stage + s * kSeg), a.src[b] + off, bytes, smem_u32(&full[s]));
  };
  for (int64_t i = 0; i < mine && i < kStages - 1; ++i) load(i);
  for (int64_t i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kStages);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / kStages) & 1));
    int b;
    int64_t off;
    uint32_t bytes;
    const int64_t out = where(i, &b, &off, &bytes);
    for (int d = 0; d < a.nd; ++d) bulk_store(a.dst[d] + out, smem_u32(stage + s * kSeg), bytes);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (i + kStages - 1 < mine) {
      // Stage (i - 1) % kStages is refilled: its stores (the group before this one) must have read it.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i + kStages - 1);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// K7 (tma) on the current device: ptrs holds nd shard pointers, then nd copy
// pointers, as dvc_ring_allgather_card takes them.
int dvc_ring_allgather_tma(const int64_t* ptrs, int nd, int64_t rows, int64_t shard, void* stream) {
  if (ptrs == nullptr || nd < 2 || nd > kMaxRanks || rows <= 0 || shard <= 0 || shard % 4 != 0)
    return cudaErrorInvalidValue;
  GatherParams a;
  a.rows = rows;
  a.shard = shard;
  a.nd = nd;
  for (int d = 0; d < nd; ++d) {
    if ((ptrs[d] | ptrs[nd + d]) & 15 || ptrs[d] == 0 || ptrs[nd + d] == 0) return cudaErrorInvalidValue;
    a.src[d] = reinterpret_cast<const float*>(ptrs[d]);
    a.dst[d] = reinterpret_cast<float*>(ptrs[nd + d]);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tma_allgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  tma_allgather_kernel<<<sms * kBlocksPerSm, 32, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* dvc_variant_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
