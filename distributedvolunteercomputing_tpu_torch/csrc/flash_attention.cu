// Flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Replaces the Pallas TPU kernels of distributedvolunteercomputing_tpu/ops/
// pallas_attention.py: _fwd_kernel (K1), _bwd_dq_kernel (K2) and
// _bwd_dkv_kernel (K3). Each kernel computes what its TPU kernel computes
// (online softmax with -1e30 masking, f32 statistics, products in the input
// dtype with f32 accumulation, P and dS rounded to the input dtype before
// their products when the inputs are bf16), not a block-by-block copy: the
// TPU walks the key (or query) stream as a sequential grid dimension and
// carries the running sums in VMEM scratch; here one thread block owns one
// output tile of one (batch, head) and walks the stream in a loop. Blocks run
// in any order on the 132 SMs and no block writes another's rows, so no
// atomics and no second pass. Causal masking is top-left aligned.
//
// Two designs:
//  - bf16 K1, K2 and K3 (namespace hopper, below): warp-specialised blocks.
//    A producer issues TMA loads of 4-D tensor maps through mbarrier rings;
//    consumer warpgroups run wgmma with operands in 128-byte-swizzled shared
//    memory and accumulators in registers. K1: 64 query rows per block, two
//    blocks per SM; O, m and l stay in registers for the whole key loop,
//    softmax runs on the S registers, P feeds P.V as the register A operand,
//    and S_j is issued with P_{j-1}.V_{j-1} so the softmax overlaps a
//    product. K2: K1's block shape, Q and dO resident, K/V streamed; S and
//    dP land in registers, dS feeds dQ += dS.K as the register A operand,
//    and the co-resident block's products fill each block's waits. K3: 128
//    keys per block, K and V resident, Q/dO tiles streamed; S^T = K.Q^T and
//    dP^T = V.dO^T land in registers, and P^T, dS^T feed dV += P^T.dO and
//    dK += dS^T.Q as register A operands. TMA zero-fills rows past T.
//  - K1, K2 and K3 in f32 (the f32 parity passes): one block per 64-row
//    tile, four warps of 16 rows, staged tiles and accumulators in shared
//    memory, products through scalar FMA. Rows past T are zero filled on
//    load and masked.
//
// Inputs are read through (batch, head, time) strides with a contiguous last
// dimension, so the head-split view of the fused qkv projection is read in
// place; the tensor maps need those strides in multiples of 16 bytes.
//
// What bounds them on an H100: at the flagship shape (B=8, H=12, T=1024,
// D=64, bf16, causal) K1 needs 12.9 GFLOP against 51 MB of traffic, so its
// bytes bound it (15 us at 3.35 TB/s); K2 needs 19.3 GFLOP and K3 25.8 GFLOP
// against 63-76 MB, so the tensor cores bound them (20 / 26 us at 989
// TFLOP/s). The f32 design is far from its bound. Measured times beside
// the bounds: PERF.md section 6, from chip_smoke.py's kernels phase.
//
// Plain C interface (bound with ctypes); each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime's driver entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // key rows per tile
constexpr int NWARPS = 4;   // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value, not -inf

struct Strides {
  long long b, h, t;  // in elements; the last dimension is contiguous
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row pitches (in elements) of the shared-memory tiles of the f32 kernels.
// P / dS share the score buffers, which is what fits the D=128 dk/dv kernel
// into 227 KB.
template <typename T, int D>
struct Cfg {
  static_assert(std::is_same<T, float>::value, "bf16 goes to the kernels of namespace hopper");
  static constexpr int LDT = D;       // staged Q/K/V/dO tiles
  static constexpr int LDS = BK + 4;  // score tiles, and P / dS over them
  static constexpr int LDA = D;       // output accumulators
  static constexpr size_t TILE = sizeof(T) * BQ * LDT;
  static constexpr size_t SCORE = 4 * BQ * LDS;
  static constexpr size_t ACC = 4 * BQ * LDA;
};

// ---------------------------------------------------------------------------
// Warp-level products over shared memory: 16 output rows per warp.
// ---------------------------------------------------------------------------

template <typename T>
struct WarpMma;

template <>
struct WarpMma<float> {
  template <int N, int K>
  static __device__ __forceinline__ void abt(const float* A, int lda, const float* B, int ldb,
                                             float* C, int ldc) {
    const int lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int r = idx / N, c = idx % N;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = fmaf(A[r * lda + k], B[c * ldb + k], s);
      C[r * ldc + c] = s;
    }
  }

  template <int N, int K>
  static __device__ __forceinline__ void ab_acc(const float* A, int lda, const float* B, int ldb,
                                                float* C, int ldc) {
    const int lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int r = idx / N, c = idx % N;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = fmaf(A[r * lda + k], B[k * ldb + c], s);
      C[r * ldc + c] += s;
    }
  }

  template <int N, int K>
  static __device__ __forceinline__ void atb_acc(const float* A, int lda, const float* B, int ldb,
                                                 float* C, int ldc) {
    const int lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int r = idx / N, c = idx % N;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = fmaf(A[k * lda + r], B[k * ldb + c], s);
      C[r * ldc + c] += s;
    }
  }
};

// ---------------------------------------------------------------------------
// Tile movement between device memory and shared memory (16 bytes a thread).
// ---------------------------------------------------------------------------

// Stage rows [row0, row0 + 64) of one (batch, head) slice; rows at or past
// `nrows` are zero filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long st, int row0, int nrows) {
  constexpr int LD = Cfg<T, D>::LDT;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(g + (row0 + r) * st + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

// Write rows [row0, row0 + 64) of an f32 accumulator tile times `mul`,
// rounded to T; rows at or past `nrows` are not written.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* g, long long st, const float* sm, float mul, int row0,
                                           int nrows) {
  constexpr int LD = Cfg<T, D>::LDA;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    if (row0 + r >= nrows) continue;
    alignas(16) T pack[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) pack[e] = sm[r * LD + c + e] * mul;
    *reinterpret_cast<uint4*>(g + (row0 + r) * st + c) = *reinterpret_cast<const uint4*>(pack);
  }
}

// ---------------------------------------------------------------------------
// K1 in f32: forward. Grid (q-tiles, H, B); block = one 64-row query tile.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  using C = Cfg<T, D>;
  static constexpr size_t q = 0, k = q + C::TILE, v = k + C::TILE, s = v + C::TILE;
  static constexpr size_t acc = s + C::SCORE, m = acc + C::ACC;
  static constexpr size_t l = m + 4 * BQ, bytes = l + 4 * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int Tq, int Tk, float scale, int causal) {
  using C = Cfg<T, D>;
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::s);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int n_q = (Tq + BQ - 1) / BQ;
  const int iq = n_q - 1 - blockIdx.x;  // longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  lse += ((long long)b * H + h) * Tq;

  load_tile<T, D>(sQ, q, sq.t, iq * BQ, Tq);
  for (int i = threadIdx.x; i < BQ * C::LDA; i += NTHREADS) sAcc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  const int n_k = (Tk + BK - 1) / BK;
  const int last = causal ? min(n_k - 1, ((iq + 1) * BQ - 1) / BK) : n_k - 1;

  for (int jk = 0; jk <= last; ++jk) {
    load_tile<T, D>(sK, k, sk.t, jk * BK, Tk);
    load_tile<T, D>(sV, v, sv.t, jk * BK, Tk);
    __syncthreads();
    WarpMma<T>::template abt<BK, D>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS,
                                     C::LDS);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, row = iq * BQ + r;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, col = jk * BK + c;
        const bool ok = col < Tk && (!causal || col <= row);
        s[half] = ok ? sS[r * C::LDS + c] * scale : NEG_INF;
        mx = fmaxf(mx, s[half]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float p = expf(s[half] - m_new);
        psum += p;
        sP[r * C::LDS + lane + 32 * half] = p;
      }
      psum = warp_sum(psum);
      for (int c = lane; c < D; c += 32) sAcc[r * C::LDA + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_new;
      }
    }
    __syncwarp();
    WarpMma<T>::template ab_acc<D, BK>(sP + r0 * C::LDS, C::LDS, sV, C::LDT, sAcc + r0 * C::LDA,
                                        C::LDA);
    __syncthreads();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, row = iq * BQ + r;
    const float l = sL[r];
    const float l_safe = l == 0.f ? 1.f : l;
    for (int c = lane; c < D; c += 32) sAcc[r * C::LDA + c] = sAcc[r * C::LDA + c] / l_safe;
    if (lane == 0 && row < Tq) lse[row] = sM[r] + logf(l_safe);
  }
  __syncthreads();
  store_tile<T, D>(o, so.t, sAcc, 1.f, iq * BQ, Tq);
}

// ---------------------------------------------------------------------------
// K2 in f32: dq. Grid (q-tiles, H, B); block = one 64-row query tile.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  using C = Cfg<T, D>;
  static constexpr size_t q = 0, dO = q + C::TILE, k = dO + C::TILE, v = k + C::TILE;
  static constexpr size_t s = v + C::TILE, dp = s + C::SCORE, acc = dp + C::SCORE;
  static constexpr size_t lse = acc + C::ACC, delta = lse + 4 * BQ;
  static constexpr size_t bytes = delta + 4 * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, int H, int Tq, int Tk, float scale,
                    int causal) {
  using C = Cfg<T, D>;
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dO);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sDS = reinterpret_cast<T*>(smem + L::dp);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int n_q = (Tq + BQ - 1) / BQ;
  const int iq = n_q - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dO += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
  lse += ((long long)b * H + h) * Tq;
  delta += ((long long)b * H + h) * Tq;

  load_tile<T, D>(sQ, q, sq.t, iq * BQ, Tq);
  load_tile<T, D>(sDO, dO, sdo.t, iq * BQ, Tq);
  for (int i = threadIdx.x; i < BQ * C::LDA; i += NTHREADS) sAcc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    const int row = iq * BQ + i;
    sLse[i] = row < Tq ? lse[row] : 0.f;
    sDelta[i] = row < Tq ? delta[row] : 0.f;
  }
  const int n_k = (Tk + BK - 1) / BK;
  const int last = causal ? min(n_k - 1, ((iq + 1) * BQ - 1) / BK) : n_k - 1;

  for (int jk = 0; jk <= last; ++jk) {
    load_tile<T, D>(sK, k, sk.t, jk * BK, Tk);
    load_tile<T, D>(sV, v, sv.t, jk * BK, Tk);
    __syncthreads();
    WarpMma<T>::template abt<BK, D>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS,
                                     C::LDS);
    WarpMma<T>::template abt<BK, D>(sDO + r0 * C::LDT, C::LDT, sV, C::LDT, sDP + r0 * C::LDS,
                                     C::LDS);
    __syncwarp();
    for (int idx = lane; idx < 16 * BK; idx += 32) {
      const int r = r0 + idx / BK, c = idx % BK;
      const int row = iq * BQ + r, col = jk * BK + c;
      const bool ok = col < Tk && (!causal || col <= row);
      const float s = ok ? sS[r * C::LDS + c] * scale : NEG_INF;
      const float p = expf(s - sLse[r]);
      const float ds = p * (sDP[r * C::LDS + c] - sDelta[r]);
      sDS[r * C::LDS + c] = ds;
    }
    __syncwarp();
    WarpMma<T>::template ab_acc<D, BK>(sDS + r0 * C::LDS, C::LDS, sK, C::LDT,
                                        sAcc + r0 * C::LDA, C::LDA);
    __syncthreads();
  }
  store_tile<T, D>(dq, sdq.t, sAcc, scale, iq * BQ, Tq);
}

// ---------------------------------------------------------------------------
// K3 in f32: dk and dv. Grid (k-tiles, H, B); block = one 64-row key tile that
// walks the query tiles from the first one its keys are visible to.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using C = Cfg<T, D>;
  static constexpr size_t k = 0, v = k + C::TILE, q = v + C::TILE, dO = q + C::TILE;
  static constexpr size_t s = dO + C::TILE, dp = s + C::SCORE, dk = dp + C::SCORE;
  static constexpr size_t dv = dk + C::ACC;
  static constexpr size_t lse = dv + C::ACC, delta = lse + 4 * BQ, bytes = delta + 4 * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int H, int Tq, int Tk, float scale, int causal) {
  using C = Cfg<T, D>;
  using L = DkvSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dO);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sP = reinterpret_cast<T*>(smem + L::s);
  T* sDS = reinterpret_cast<T*>(smem + L::dp);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int jk = blockIdx.x;  // low key tiles see the most query tiles: start them first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dO += b * sdo.b + h * sdo.h;
  dk += b * sdk.b + h * sdk.h;
  dv += b * sdv.b + h * sdv.h;
  lse += ((long long)b * H + h) * Tq;
  delta += ((long long)b * H + h) * Tq;

  load_tile<T, D>(sK, k, sk.t, jk * BK, Tk);
  load_tile<T, D>(sV, v, sv.t, jk * BK, Tk);
  for (int i = threadIdx.x; i < BK * C::LDA; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  const int n_q = (Tq + BQ - 1) / BQ;
  const int first = causal ? (jk * BK) / BQ : 0;

  for (int iq = first; iq < n_q; ++iq) {
    load_tile<T, D>(sQ, q, sq.t, iq * BQ, Tq);
    load_tile<T, D>(sDO, dO, sdo.t, iq * BQ, Tq);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const int row = iq * BQ + i;
      sLse[i] = row < Tq ? lse[row] : 0.f;
      sDelta[i] = row < Tq ? delta[row] : 0.f;
    }
    __syncthreads();
    // Warps own query rows here ...
    WarpMma<T>::template abt<BK, D>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS,
                                     C::LDS);
    WarpMma<T>::template abt<BK, D>(sDO + r0 * C::LDT, C::LDT, sV, C::LDT, sDP + r0 * C::LDS,
                                     C::LDS);
    __syncwarp();
    for (int idx = lane; idx < 16 * BK; idx += 32) {
      const int r = r0 + idx / BK, c = idx % BK;
      const int row = iq * BQ + r, col = jk * BK + c;
      const bool ok = row < Tq && col < Tk && (!causal || col <= row);
      const float p = ok ? expf(sS[r * C::LDS + c] * scale - sLse[r]) : 0.f;
      const float ds = p * (sDP[r * C::LDS + c] - sDelta[r]);
      sP[r * C::LDS + c] = p;
      sDS[r * C::LDS + c] = ds;
    }
    __syncthreads();
    // ... and key rows here: dV += P^T dO, dK += dS^T Q.
    WarpMma<T>::template atb_acc<D, BQ>(sP + r0, C::LDS, sDO, C::LDT, sDV + r0 * C::LDA, C::LDA);
    WarpMma<T>::template atb_acc<D, BQ>(sDS + r0, C::LDS, sQ, C::LDT, sDK + r0 * C::LDA, C::LDA);
    __syncthreads();
  }
  store_tile<T, D>(dk, sdk.t, sDK, scale, jk * BK, Tk);
  store_tile<T, D>(dv, sdv.t, sDV, 1.f, jk * BK, Tk);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ===========================================================================
// bf16 K1, K2 and K3 on Hopper: wgmma with register-resident accumulators,
// fed by TMA through mbarrier rings, warp-specialised.
//
// A producer (one thread of a producer warp or warpgroup) issues TMA loads of
// 4-D tensor maps (D, T, H, B) straight from the caller's strided views (the
// head-split view of the fused qkv projection too); rows past T arrive as
// zeros. Consumer warpgroups of 64 rows run the products. Tiles sit in shared
// memory in 128-byte swizzled rows, D split into 64-column panels: TMA writes
// that layout and the wgmma descriptors read it (K-major for the Q.K^T-style
// products, MN-major for the V / K / dO / Q operand of the second product).
//
// K1: a block is one consumer warpgroup (64 query rows) and a producer warp,
// two blocks per SM, K and V in 64-key stages with their own barriers. Step
// j issues S_j = Q.K_j^T and O += P_{j-1}.V_{j-1} together and runs the
// softmax of S_j while P.V finishes; the co-resident block's products fill
// the rest. K2 has K1's block shape around S, dP and dQ += dS.K, without
// the overlap inside the warpgroup. K3: a block is a producer warpgroup
// and two consumer warpgroups (128 keys, K and V resident), with setmaxnreg
// moving registers from the producer to the consumers, which hold dK and dV.
// ===========================================================================

namespace hopper {

constexpr int kPanel = 64;  // bf16 columns per 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // the reference's mask value, not -inf

// --- shared memory, barriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy one box (64 columns x rows) of a 4-D tensor map into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + rows) of one (batch, head) slice as D / 64 panels of
// [rows][64], each panel rows * 128 bytes.
template <int D>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int row0, int rows, int h, int b) {
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p) tma_load(map, dst + p * rows * 128, bar, p * kPanel, row0, h, b);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). Tiles start 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Offsets (16-byte units) of k-step kk from a tile's base descriptor.
// K-major operand (rows of a tile, D contiguous, panels `panel_bytes` apart):
// the kk-th 16-column slice is 32 bytes into a 128-byte row; 8-row swizzle
// atoms are 1024 bytes apart (SBO), LBO is unused.
__host__ __device__ constexpr uint32_t kmajor_off(int kk, uint32_t panel_bytes) {
  return ((kk / 4) * panel_bytes + (kk % 4) * 32) >> 4;
}
// MN-major B operand ([K][D] tile read as K x N with N = D): the kk-th
// 16-row slice is two 1024-byte atoms along K (SBO); the 64-column panels
// along N are `panel_bytes` apart (LBO).
__host__ __device__ constexpr uint32_t mnmajor_off(int kk) { return (kk * 16 * 128) >> 4; }

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile) { return smem_desc(tile, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, uint32_t panel_bytes) {
  return smem_desc(tile, panel_bytes, 1024);
}

// f(std::integral_constant<int, i>) for i in [0, N): k-steps whose
// descriptor offsets are immediates of the instruction, so only the tiles'
// base descriptors occupy registers.
template <class F, int... I>
__device__ __forceinline__ void unroll_impl(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_impl(f, std::make_integer_sequence<int, N>{});
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin register arrays across the asynchronous products: reads after the
// wait stay after it, and registers a product reads are not reused before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// m64nNk16, f32 accumulators in bf16 x bf16. Per thread of the warpgroup,
// d[4j + 2i + c] is element (16 * warp + lane / 4 + 8i, 8j + 2 * (lane % 4) + c).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d[32] (+)= A . B^T, A and B K-major in shared memory: descriptors da, db
  // advanced by OA, OB (16-byte units) inside the instruction's own block.
  template <uint32_t OA, uint32_t OB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 adesc, bdesc;\n"
        "add.s64 adesc, %32, %35;\n"
        "add.s64 bdesc, %33, %36;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        " adesc, bdesc, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
  }
  // d[32] += A . B, A bf16 in registers (accumulator layout), B MN-major in
  // shared memory: descriptor db advanced by OB.
  template <uint32_t OB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 bdesc;\n"
        "add.s64 bdesc, %36, %38;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, bdesc, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OB));
  }
};

template <>
struct Wgmma<128> {
  // d[64] += A . B, A bf16 in registers (accumulator layout), B MN-major in
  // shared memory: descriptor db advanced by OB.
  template <uint32_t OB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 bdesc;\n"
        "add.s64 bdesc, %68, %70;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, bdesc, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OB));
  }
};

// Round an m64nNk16 accumulator to bf16 as the A operand of the next
// product (its columns become that product's K): columns 16kk..16kk+15 of
// the accumulator layout are exactly the register fragment of k-step kk.
template <int NREG>
__device__ __forceinline__ void to_a_frags(const float (&d)[NREG], uint32_t (&a)[NREG / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NREG / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
      a[kk][r] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A row's values sit in the 4 lanes of a quad.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t aligned_base(unsigned char* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
}

// --- K1 ----------------------------------------------------------------------

// K1 blocks are one consumer warpgroup (warps 0-3, 64 query rows) and one
// producer warp (warp 4); two blocks share an SM, so one block's first loads
// and epilogue overlap the other's products.
constexpr int kFwdRows = 64;
constexpr int kFwdThreads = 160;
constexpr int kFwdKeys = 64;  // keys per stage
constexpr int kFwdStages = 2;

template <int D>
struct FwdLayout {
  static constexpr uint32_t kv_tile = kFwdKeys * D * 2;
  static constexpr uint32_t q = 0;                         // [kFwdRows][D]
  static constexpr uint32_t k = q + kFwdRows * D * 2;      // kFwdStages stages of K
  static constexpr uint32_t v = k + kFwdStages * kv_tile;  // kFwdStages stages of V
  static constexpr uint32_t bars = v + kFwdStages * kv_tile;  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr uint32_t bytes = bars + (1 + 4 * kFwdStages) * 8 + 1024;  // + alignment slack
};

// Grid (H, B, query blocks); a block owns 64 query rows. O, m and l stay in
// registers over the whole key loop. Step jk issues S_jk = Q.K_jk^T and
// O += P_{jk-1}.V_{jk-1} together, then runs the softmax of S_jk while the
// tensor cores finish P.V.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, Strides so, int H, int Tq, int Tk, float scale_log2,
                     int causal) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = aligned_base(hopper_smem);
  const uint32_t sq = base + L::q, bar_q = base + L::bars;
  // Tile jk sits in stage jk % kFwdStages, on that stage's (jk / kFwdStages)-th use.
  const auto k_full = [=](int jk) { return bar_q + 8 + 32 * (jk % kFwdStages); };
  const auto v_full = [=](int jk) { return bar_q + 16 + 32 * (jk % kFwdStages); };
  const auto k_empty = [=](int jk) { return bar_q + 24 + 32 * (jk % kFwdStages); };
  const auto v_empty = [=](int jk) { return bar_q + 32 + 32 * (jk % kFwdStages); };
  const auto use = [](int jk) { return (jk / kFwdStages) & 1; };  // parity of the stage's use
  const auto k_tile = [=](int jk) { return base + L::k + (jk % kFwdStages) * L::kv_tile; };
  const auto v_tile = [=](int jk) { return base + L::v + (jk % kFwdStages) * L::kv_tile; };
  const int n_q = (Tq + kFwdRows - 1) / kFwdRows;
  // Blocks start in linear order (x fastest): every head's longest causal
  // rows first, so the short blocks fill in at the end.
  const int h = blockIdx.x, b = blockIdx.y, iq = n_q - 1 - blockIdx.z;
  const int n_k = (Tk + kFwdKeys - 1) / kFwdKeys;
  const int last = causal ? min(n_k - 1, ((iq + 1) * kFwdRows - 1) / kFwdKeys) : n_k - 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(k_full(s), 1);  // the producer's expect_tx
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4);  // one arrival per consumer warp
      mbar_init(v_empty(s), 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, kFwdRows * D * 2);
      tma_tile<D>(&tq, sq, bar_q, iq * kFwdRows, kFwdRows, h, b);
      for (int jk = 0; jk <= last; ++jk) {
        mbar_wait(k_empty(jk), use(jk) ^ 1);  // the first use of a stage does not wait
        mbar_expect_tx(k_full(jk), L::kv_tile);
        tma_tile<D>(&tk, k_tile(jk), k_full(jk), jk * kFwdKeys, kFwdKeys, h, b);
        mbar_wait(v_empty(jk), use(jk) ^ 1);
        mbar_expect_tx(v_full(jk), L::kv_tile);
        tma_tile<D>(&tv, v_tile(jk), v_full(jk), jk * kFwdKeys, kFwdKeys, h, b);
      }
    }
  } else {
    const int t = threadIdx.x, lane = t & 31, quad = lane & 3;
    const int row_lo = iq * kFwdRows;
    const int row0 = row_lo + 16 * (t >> 5) + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const uint64_t d_q = desc_kmajor(sq);
    float acc[D / 2], sc[kFwdKeys / 2];
    uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const float masked_score = kNegInf / (scale_log2 / kLog2e);  // -1e30 once scaled
    float m[2] = {masked_score, masked_score}, l[2] = {0.f, 0.f};  // m: unscaled row max
    const auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S_jk = Q.K_jk^T from the K stage of tile jk.
    const auto issue_s = [&](int jk) {
      const uint64_t d_k = desc_kmajor(k_tile(jk));
      unroll<D / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<kFwdKeys>::template ss<kmajor_off(i, kFwdRows * 128), kmajor_off(i, kFwdKeys * 128)>(sc, d_q, d_k, i);
      });
    };
    // O += P.V_jk from the V stage of tile jk.
    const auto issue_pv = [&](int jk) {
      const uint64_t d_v = desc_mnmajor(v_tile(jk), kFwdKeys * 128);
      unroll<kFwdKeys / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<D>::template rs<mnmajor_off(i)>(acc, pa[i], d_v);
      });
    };
    // Online softmax of S_jk: sc becomes P (f32), m and l move on, corr
    // rescales O. m is kept on the unscaled scores, and each P is one FFMA
    // and an exp2: exp(s * scale - m * scale) = 2^(s * c - m * c), c = scale *
    // log2 e (scale > 0, so the max commutes with it). Masked scores are
    // -1e30 / scale, i.e. the reference's -1e30 after scaling. The mask is
    // only applied where it can bite: the causal diagonal and keys past Tk.
    float corr[2];
    const auto softmax = [&](int jk) {
      const int key0 = jk * kFwdKeys;
      const bool masked = (causal && key0 + kFwdKeys - 1 > row_lo) || key0 + kFwdKeys > Tk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int col = key0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        if (masked && (col >= Tk || (causal && col > row0 + 8 * r))) sc[i] = masked_score;
        mx[r] = fmaxf(mx[r], sc[i]);
      }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = quad_max(mx[r]);
        corr[r] = ex2((m[r] - m_new) * scale_log2);
        m[r] = m_new;
        mc[r] = m_new * scale_log2;
        l[r] *= corr[r];  // each lane sums its own columns; the quad adds them at the end
      }
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -mc[r]));
        l[r] += sc[i];
      }
    };

    mbar_wait(bar_q, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_s(0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    release(k_empty(0));
    softmax(0);
    to_a_frags(sc, pa);  // P rounded to bf16 before P.V, as the reference

    for (int jk = 1; jk <= last; ++jk) {
      mbar_wait(k_full(jk), use(jk));
      mbar_wait(v_full(jk - 1), use(jk - 1));
      wg_fence();
      issue_s(jk);
      wg_commit();
      issue_pv(jk - 1);
      wg_commit();
      wg_wait<1>();  // S_jk done; P_{jk-1}.V_{jk-1} may still run
      fence_regs(sc);
      release(k_empty(jk));
      softmax(jk);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(v_empty(jk - 1));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      to_a_frags(sc, pa);
    }
    mbar_wait(v_full(last), use(last));
    wg_fence();
    issue_pv(last);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

    o += b * so.b + h * so.h;
    lse += (static_cast<long long>(b) * H + h) * Tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      const float l_safe = lt == 0.f ? 1.f : lt;
      const float inv = 1.f / l_safe;
      const int row = row0 + 8 * r;
      if (row < Tq) {
        bf16* orow = o + row * so.t + 2 * quad;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        if (quad == 0) lse[row] = m[r] * (scale_log2 * kLn2) + logf(l_safe);
      }
    }
  }
}

// --- K3 ----------------------------------------------------------------------

constexpr int kThreads = 384;  // warpgroup 0: producer; warpgroups 1, 2: consumers
constexpr int kRows = 128;     // keys per block (64 per consumer)
constexpr int kQRows = 64;     // query rows per pipeline stage
constexpr int kConsumerWarps = 8;
// Registers per thread after setmaxnreg: producer warpgroup + two consumer
// warpgroups = 384 x 168, what the block was launched with.
constexpr int kDkvProducerRegs = 40, kDkvConsumerRegs = 232;

template <int D>
struct DkvLayout {
  static constexpr uint32_t kv_tile = kRows * D * 2, qdo_tile = kQRows * D * 2;
  static constexpr uint32_t k = 0, v = k + kv_tile;          // resident [kRows][D] each
  static constexpr uint32_t qdo = v + kv_tile;               // per stage: Q, then dO
  static constexpr uint32_t stats = qdo + 2 * 2 * qdo_tile;  // per stage: lse * log2 e, delta
  static constexpr uint32_t bars = stats + 2 * 2 * kQRows * 4;  // kv_full, full[2], empty[2]
  static constexpr uint32_t bytes = bars + 5 * 8 + 1024;
};

// Grid (key blocks, H, B); a block owns 128 keys and walks the query tiles
// from the first one its keys are visible to. dK and dV stay in registers;
// S^T, dP^T, P^T and dS^T never leave them.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv, int H,
                     int Tq, int Tk, float scale, int causal) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = aligned_base(hopper_smem);
  float* stats = reinterpret_cast<float*>(hopper_smem + (base - smem_u32(hopper_smem)) + L::stats);
  const uint32_t bar_kv = base + L::bars;
  // Every head's low key blocks (which see the most query tiles) start first.
  const int h = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;
  const int n_q = (Tq + kQRows - 1) / kQRows;
  const int first = causal ? (kb * kRows) / kQRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_kv + 8 + 8 * s, 1 + 32);           // full[s]: the TMA lane and the stats warp
      mbar_init(bar_kv + 24 + 8 * s, kConsumerWarps);  // empty[s]
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kDkvProducerRegs>();
    if (threadIdx.x == 0) {  // TMA: K and V once, then the Q/dO ring
      mbar_expect_tx(bar_kv, 2 * L::kv_tile);
      tma_tile<D>(&tk, base + L::k, bar_kv, kb * kRows, kRows, h, b);
      tma_tile<D>(&tv, base + L::v, bar_kv, kb * kRows, kRows, h, b);
      for (int iq = first; iq < n_q; ++iq) {
        const int it = iq - first, s = it & 1;
        const uint32_t full = bar_kv + 8 + 8 * s, tile = base + L::qdo + s * 2 * L::qdo_tile;
        mbar_wait(bar_kv + 24 + 8 * s, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::qdo_tile);
        tma_tile<D>(&tq, tile, full, iq * kQRows, kQRows, h, b);
        tma_tile<D>(&tdo, tile + L::qdo_tile, full, iq * kQRows, kQRows, h, b);
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {  // the tiles' lse and delta
      const int lane = threadIdx.x - 32;
      lse += (static_cast<long long>(b) * H + h) * Tq;
      delta += (static_cast<long long>(b) * H + h) * Tq;
      for (int iq = first; iq < n_q; ++iq) {
        const int it = iq - first, s = it & 1;
        mbar_wait(bar_kv + 24 + 8 * s, ((it >> 1) & 1) ^ 1);
        float* st = stats + s * 2 * kQRows;
        for (int i = lane; i < kQRows; i += 32) {
          const int row = iq * kQRows + i;
          // Rows past Tq: lse = +1e30 makes P = 0 there (the reference's padding).
          st[i] = row < Tq ? lse[row] * kLog2e : 1e30f;
          st[kQRows + i] = row < Tq ? delta[row] : 0.f;
        }
        mbar_arrive(bar_kv + 8 + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc<kDkvConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;  // which 64 keys of the block
    const int t = threadIdx.x % 128, lane = t & 31, quad = lane & 3;
    const int key_lo = kb * kRows + 64 * wg;
    const int key0 = key_lo + 16 * (t >> 5) + (lane >> 2);  // this thread's keys: key0, key0 + 8
    const uint32_t a_k = base + L::k + wg * 64 * 128, a_v = base + L::v + wg * 64 * 128;
    const float scale_log2 = scale * kLog2e;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int iq = first; iq < n_q; ++iq) {
      const int it = iq - first, s = it & 1;
      const uint32_t sq = base + L::qdo + s * 2 * L::qdo_tile, sdo = sq + L::qdo_tile;
      const float* st = stats + s * 2 * kQRows;
      mbar_wait(bar_kv + 8 + 8 * s, (it >> 1) & 1);
      float p[kQRows / 2], ds[kQRows / 2];  // S^T then P^T; dP^T then dS^T
      const uint64_t d_k = desc_kmajor(a_k), d_v = desc_kmajor(a_v);
      const uint64_t d_q = desc_kmajor(sq), d_do = desc_kmajor(sdo);
      wg_fence();
      unroll<D / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<kQRows>::ss<kmajor_off(i, kRows * 128), kmajor_off(i, kQRows * 128)>(p, d_k, d_q, i);
      });
      unroll<D / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<kQRows>::ss<kmajor_off(i, kRows * 128), kmajor_off(i, kQRows * 128)>(ds, d_v, d_do, i);
      });
      wg_commit();
      wg_wait<0>();
      fence_regs(p);
      fence_regs(ds);

      const int q_lo = iq * kQRows;
      const bool masked = causal && key_lo + 63 > q_lo;  // some key of this warpgroup is after some row
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j) {
        const int c = 8 * j + 2 * quad;  // query rows c, c + 1 within the tile
        const float2 lse2 = *reinterpret_cast<const float2*>(st + c);
        const float2 dlt = *reinterpret_cast<const float2*>(st + kQRows + c);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          float pi = ex2(fmaf(p[i], scale_log2, -((i & 1) ? lse2.y : lse2.x)));
          if (masked && q_lo + c + (i & 1) < key0 + 8 * ((i >> 1) & 1)) pi = 0.f;
          ds[i] = pi * (ds[i] - ((i & 1) ? dlt.y : dlt.x));
          p[i] = pi;
        }
      }
      uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];
      to_a_frags(p, pa);  // P^T and dS^T rounded to bf16 before their products
      to_a_frags(ds, dsa);

      const uint64_t b_do = desc_mnmajor(sdo, kQRows * 128), b_q = desc_mnmajor(sq, kQRows * 128);
      wg_fence();
      unroll<kQRows / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<D>::template rs<mnmajor_off(i)>(dva, pa[i], b_do);
      });
      unroll<kQRows / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<D>::template rs<mnmajor_off(i)>(dka, dsa[i], b_q);
      });
      wg_commit();
      wg_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_kv + 24 + 8 * s);
    }

    dk += b * sdk.b + h * sdk.h;
    dv += b * sdv.b + h * sdv.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Tk) continue;
      bf16* krow = dk + key * sdk.t + 2 * quad;
      bf16* vrow = dv + key * sdv.t + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) = pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// --- K2 ----------------------------------------------------------------------

// K2 blocks are K1's shape: one consumer warpgroup (warps 0-3, 64 query rows,
// Q and dO resident) and one producer warp (warp 4) streaming K and V in
// 64-key stages; two blocks share an SM. K is read twice, by S_j = Q.K_j^T
// and, one step later, by dQ += dS_j.K_j. Step j issues dQ += dS_{j-1}.K_{j-1},
// waits for it, releases stage j-1 and only then issues S_j and dP_j, so
// dS's registers are free before S and dP are written; the co-resident
// block fills the tensor cores. Issuing S_j and dP_j beside dQ instead, as
// K1 overlaps its softmax, was slower at D=64 and did not fit D=128 (dQ is
// 64 f32 a thread there; ptxas spilled and serialised the products in the
// 168 registers two blocks leave a thread).
constexpr int kDqRows = 64;
constexpr int kDqThreads = 160;
constexpr int kDqKeys = 64;  // keys per stage

template <int D>
struct DqLayout {
  static constexpr int stages = D == 64 ? 3 : 2;  // three do not fit two blocks at D=128
  static constexpr uint32_t tile = kDqKeys * D * 2;  // one [64][D] bf16 tile
  static constexpr uint32_t q = 0, dO = q + tile;    // resident
  static constexpr uint32_t kv = dO + tile;          // per stage: K, then V
  static constexpr uint32_t bars = kv + stages * 2 * tile;  // qd_full, then full, empty per stage
  static constexpr uint32_t bytes = bars + (1 + 2 * stages) * 8 + 1024;  // + alignment slack
};

// Grid (H, B, query blocks); a block owns 64 query rows and walks the key
// tiles its rows see. dQ stays in registers for the whole loop; S, dP, P
// and dS never leave them.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 2)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, Strides sdq, int H, int Tq, int Tk, float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int S = L::stages;
  extern __shared__ __align__(1024) unsigned char hopper_smem[];
  const uint32_t base = aligned_base(hopper_smem);
  const uint32_t sq = base + L::q, sdo = base + L::dO, bar_qd = base + L::bars;
  // Tile j sits in stage j % S, on that stage's (j / S)-th use.
  const auto full = [=](int j) { return bar_qd + 8 + 16 * (j % S); };
  const auto empty = [=](int j) { return bar_qd + 16 + 16 * (j % S); };
  const auto use = [](int j) { return (j / S) & 1; };
  const auto k_tile = [=](int j) { return base + L::kv + (j % S) * 2 * L::tile; };
  const auto v_tile = [=](int j) { return base + L::kv + (j % S) * 2 * L::tile + L::tile; };
  const int n_q = (Tq + kDqRows - 1) / kDqRows;
  // Blocks start in linear order (x fastest): every head's longest causal
  // rows first, so the short blocks fill in at the end.
  const int h = blockIdx.x, b = blockIdx.y, iq = n_q - 1 - blockIdx.z;
  const int n_k = (Tk + kDqKeys - 1) / kDqKeys;
  const int last = causal ? min(n_k - 1, ((iq + 1) * kDqRows - 1) / kDqKeys) : n_k - 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_qd, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_qd, 2 * L::tile);
      tma_tile<D>(&tq, sq, bar_qd, iq * kDqRows, kDqRows, h, b);
      tma_tile<D>(&tdo, sdo, bar_qd, iq * kDqRows, kDqRows, h, b);
      for (int j = 0; j <= last; ++j) {
        mbar_wait(empty(j), use(j) ^ 1);  // the first use of a stage does not wait
        mbar_expect_tx(full(j), 2 * L::tile);
        tma_tile<D>(&tk, k_tile(j), full(j), j * kDqKeys, kDqKeys, h, b);
        tma_tile<D>(&tv, v_tile(j), full(j), j * kDqKeys, kDqKeys, h, b);
      }
    }
  } else {
    const int t = threadIdx.x, lane = t & 31, quad = lane & 3;
    const int row_lo = iq * kDqRows;
    const int row0 = row_lo + 16 * (t >> 5) + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const float scale_log2 = scale * kLog2e;
    // The rows' lse (times log2 e) and delta, loaded once. Rows past Tq:
    // lse = +1e30 makes P = 0 there (the reference's padding).
    float lse2[2], dlt[2];
    {
      const long long bh = (static_cast<long long>(b) * H + h) * Tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse2[r] = row < Tq ? lse[bh + row] * kLog2e : 1e30f;
        dlt[r] = row < Tq ? delta[bh + row] : 0.f;
      }
    }
    const uint64_t d_q = desc_kmajor(sq), d_do = desc_kmajor(sdo);
    float acc[D / 2], sc[kDqKeys / 2], dp[kDqKeys / 2];
    uint32_t dsa[kDqKeys / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S_j = Q.K_j^T and dP_j = dO.V_j^T from the stage of tile j.
    const auto issue_s_dp = [&](int j) {
      const uint64_t d_k = desc_kmajor(k_tile(j)), d_v = desc_kmajor(v_tile(j));
      unroll<D / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<kDqKeys>::template ss<kmajor_off(i, kDqRows * 128), kmajor_off(i, kDqKeys * 128)>(sc, d_q, d_k, i);
      });
      unroll<D / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<kDqKeys>::template ss<kmajor_off(i, kDqRows * 128), kmajor_off(i, kDqKeys * 128)>(dp, d_do, d_v, i);
      });
    };
    // dQ += dS.K_j, K read as the MN-major B operand (as V in K1's P.V).
    const auto issue_dq = [&](int j) {
      const uint64_t d_k = desc_mnmajor(k_tile(j), kDqKeys * 128);
      unroll<kDqKeys / 16>([&](auto kk) {
        constexpr int i = decltype(kk)::value;
        Wgmma<D>::template rs<mnmajor_off(i)>(acc, dsa[i], d_k);
      });
    };
    // dp becomes dS_j = P (dP - delta), P = exp(S scale - lse) as one FFMA
    // and an exp2. Masked keys (the causal diagonal, keys past Tk) get P = 0,
    // which is what exp(-1e30 - lse) is in the reference.
    const auto form_ds = [&](int j) {
      const int key0 = j * kDqKeys;
      const bool masked = (causal && key0 + kDqKeys - 1 > row_lo) || key0 + kDqKeys > Tk;
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int col = key0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (masked && (col >= Tk || (causal && col > row0 + 8 * r))) p = 0.f;
        dp[i] = p * (dp[i] - dlt[r]);
      }
    };

    mbar_wait(bar_qd, 0);
    mbar_wait(full(0), 0);
    wg_fence();
    issue_s_dp(0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    form_ds(0);
    to_a_frags(dp, dsa);  // dS rounded to bf16 before dS.K, as the reference

    for (int j = 1; j <= last; ++j) {
      wg_fence();
      issue_dq(j - 1);
      wg_commit();
      mbar_wait(full(j), use(j));
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(dsa);
      release(empty(j - 1));
      wg_fence();
      issue_s_dp(j);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      form_ds(j);
      to_a_frags(dp, dsa);
    }
    wg_fence();
    issue_dq(last);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);

    dq += b * sdq.b + h * sdq.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Tq) continue;
      bf16* drow = dq + row * sdq.t + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// --- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point: no link
// against libcuda.
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A 4-D map (D, T, H, B) over a bf16 [B, H, T, D] view with element strides
// `s` (last dimension contiguous), read in boxes of 64 columns by `rows`
// rows, 128-byte swizzled; rows at or past T read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, Strides s, int B, int H, int T, int D, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2, static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, Strides sq,
                       Strides sk, Strides sv, Strides so, int B, int H, int Tq, int Tk, float scale,
                       int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, sq, B, H, Tq, D, kFwdRows)) != cudaSuccess ||
      (err = make_map(&mk, k, sk, B, H, Tk, D, kFwdKeys)) != cudaSuccess ||
      (err = make_map(&mv, v, sv, B, H, Tk, D, kFwdKeys)) != cudaSuccess)
    return err;
  const size_t smem = FwdLayout<D>::bytes;
  if ((err = prepare(flash_fwd_kernel<D>, smem)) != cudaSuccess) return err;
  dim3 grid(H, B, (Tq + kFwdRows - 1) / kFwdRows);
  flash_fwd_kernel<D><<<grid, kFwdThreads, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o),
                                                           static_cast<float*>(lse), so, H, Tq, Tk,
                                                           scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                      const void* delta, void* dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdq, int B, int H, int Tq, int Tk, float scale, int causal,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = make_map(&mq, q, sq, B, H, Tq, D, kDqRows)) != cudaSuccess ||
      (err = make_map(&mk, k, sk, B, H, Tk, D, kDqKeys)) != cudaSuccess ||
      (err = make_map(&mv, v, sv, B, H, Tk, D, kDqKeys)) != cudaSuccess ||
      (err = make_map(&mdo, dO, sdo, B, H, Tq, D, kDqRows)) != cudaSuccess)
    return err;
  const size_t smem = DqLayout<D>::bytes;
  if ((err = prepare(flash_dq_kernel<D>, smem)) != cudaSuccess) return err;
  dim3 grid(H, B, (Tq + kDqRows - 1) / kDqRows);
  flash_dq_kernel<D><<<grid, kDqThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sdq, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                       const void* delta, void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                       Strides sdo, Strides sdk, Strides sdv, int B, int H, int Tq, int Tk,
                       float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = make_map(&mq, q, sq, B, H, Tq, D, kQRows)) != cudaSuccess ||
      (err = make_map(&mk, k, sk, B, H, Tk, D, kRows)) != cudaSuccess ||
      (err = make_map(&mv, v, sv, B, H, Tk, D, kRows)) != cudaSuccess ||
      (err = make_map(&mdo, dO, sdo, B, H, Tq, D, kQRows)) != cudaSuccess)
    return err;
  const size_t smem = DkvLayout<D>::bytes;
  if ((err = prepare(flash_dkv_kernel<D>, smem)) != cudaSuccess) return err;
  dim3 grid(H, B, (Tk + kRows - 1) / kRows);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sdk, sdv, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace hopper


// bf16 goes to the Hopper kernels; f32 to the shared-memory ones.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, Strides sq,
                Strides sk, Strides sv, Strides so, int B, int H, int Tq, int Tk, float scale,
                int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return hopper::launch_fwd<D>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, Tk, scale, causal, stream);
  } else {
    const size_t smem = FwdSmem<T, D>::bytes;
    cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), sq, sk, sv, so, H, Tq, Tk, scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* dq, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdq, int B, int H, int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return hopper::launch_dq<D>(q, k, v, dO, lse, delta, dq, sq, sk, sv, sdo, sdq, B, H, Tq, Tk, scale,
                                causal, stream);
  } else {
    const size_t smem = DqSmem<T, D>::bytes;
    cudaError_t err = prepare(flash_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dO), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, sv, sdo, sdq, H, Tq, Tk,
        scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                const void* delta, void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdk, Strides sdv, int B, int H, int Tq, int Tk, float scale,
                int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return hopper::launch_dkv<D>(q, k, v, dO, lse, delta, dk, dv, sq, sk, sv, sdo, sdk, sdv, B, H, Tq,
                                 Tk, scale, causal, stream);
  } else {
    const size_t smem = DkvSmem<T, D>::bytes;
    cudaError_t err = prepare(flash_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tk + BK - 1) / BK, H, B);
    flash_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dO), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, sv,
        sdo, sdk, sdv, H, Tq, Tk, scale, causal);
    return cudaGetLastError();
  }
}

// dtype: 0 = float32, 1 = bfloat16. D: 64 or 128.
#define DVC_DISPATCH(dtype, d, CALL)                      \
  do {                                                    \
    if ((dtype) == 1 && (d) == 64) return CALL(bf16, 64); \
    if ((dtype) == 1 && (d) == 128) return CALL(bf16, 128); \
    if ((dtype) == 0 && (d) == 64) return CALL(float, 64); \
    if ((dtype) == 0 && (d) == 128) return CALL(float, 128); \
    return cudaErrorInvalidValue;                         \
  } while (0)

}  // namespace

extern "C" {

const char* dvc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int dvc_flash_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                  void* lse, long long qb, long long qh, long long qt, long long kb, long long kh,
                  long long kt, long long vb, long long vh, long long vt, long long ob,
                  long long oh, long long ot, int B, int H, int Tq, int Tk, float scale,
                  int causal, void* stream) {
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt}, so{ob, oh, ot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DVC_FWD(T, D) launch_fwd<T, D>(q, k, v, o, lse, sq, sk, sv, so, B, H, Tq, Tk, scale, causal, st)
  DVC_DISPATCH(dtype, d, DVC_FWD);
#undef DVC_FWD
}

int dvc_flash_dq(int dtype, int d, const void* q, const void* k, const void* v, const void* dO,
                 const void* lse, const void* delta, void* dqp, long long qb, long long qh,
                 long long qt, long long kb, long long kh, long long kt, long long vb,
                 long long vh, long long vt, long long gb, long long gh, long long gt,
                 long long db, long long dh, long long dt, int B, int H, int Tq, int Tk,
                 float scale, int causal, void* stream) {
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt}, sdo{gb, gh, gt},
      sdq{db, dh, dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DVC_DQ(T, D) \
  launch_dq<T, D>(q, k, v, dO, lse, delta, dqp, sq, sk, sv, sdo, sdq, B, H, Tq, Tk, scale, causal, st)
  DVC_DISPATCH(dtype, d, DVC_DQ);
#undef DVC_DQ
}

int dvc_flash_dkv(int dtype, int d, const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* dkp, void* dvp, long long qb,
                  long long qh, long long qt, long long kb, long long kh, long long kt,
                  long long vb, long long vh, long long vt, long long gb, long long gh,
                  long long gt, long long kgb, long long kgh, long long kgt, long long vgb,
                  long long vgh, long long vgt, int B, int H, int Tq, int Tk, float scale,
                  int causal, void* stream) {
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt}, sdo{gb, gh, gt},
      sdk{kgb, kgh, kgt}, sdv{vgb, vgh, vgt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DVC_DKV(T, D)                                                                        \
  launch_dkv<T, D>(q, k, v, dO, lse, delta, dkp, dvp, sq, sk, sv, sdo, sdk, sdv, B, H, Tq, Tk, \
                   scale, causal, st)
  DVC_DISPATCH(dtype, d, DVC_DKV);
#undef DVC_DKV
}

}  // extern "C"
