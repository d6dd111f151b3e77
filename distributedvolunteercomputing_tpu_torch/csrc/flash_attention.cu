// Flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Replaces the Pallas TPU kernels of distributedvolunteercomputing_tpu/ops/
// pallas_attention.py: _fwd_kernel (K1), _bwd_dq_kernel (K2) and
// _bwd_dkv_kernel (K3). Each kernel computes what its TPU kernel computes
// (online softmax with -1e30 masking, f32 statistics, products in the input
// dtype with f32 accumulation, P and dS rounded to the input dtype before
// their products when the inputs are bf16), not a block-by-block copy:
//
//  - The TPU walks the key (or query) stream as a sequential grid dimension
//    and carries the running sums in VMEM scratch. Here one thread block owns
//    one 64-row output tile of one (batch, head) and walks the stream in a
//    loop, staging 64-row K/V (or Q/dO) tiles in shared memory. Blocks run in
//    any order on the 132 SMs, and no block writes another's rows, so no
//    atomics and no second pass are needed.
//  - Four warps; each owns 16 rows of the 64-row tile. bf16 products use the
//    tensor cores through nvcuda::wmma (m16n16k16, f32 accumulate); the f32
//    instantiation uses scalar FMA and exists for the f32 parity check.
//  - Causal masking is top-left aligned; the loop stops at the diagonal tile
//    (K1/K2) or starts there (K3). Rows past Tq and keys past Tk are zero
//    filled on load and masked, which replaces the TPU's padding and the
//    lse = +1e30 trick for padded query rows.
//  - Inputs are read through (batch, head, time) strides with a contiguous
//    last dimension, so the head-split view of the fused qkv projection is
//    read in place.
//
// What bounds them on an H100: at the flagship shape (B=8, H=12, T=1024,
// D=64, bf16, causal) each kernel needs 13-26 GFLOP against 51-76 MB of
// traffic, ~250-340 FLOP/byte, so the bound is the tensor cores (15-26 us at
// 989 TFLOP/s). This first version keeps score tiles and accumulators in
// shared memory and issues wmma from there; it is well short of that bound.
// wgmma, TMA and register-resident accumulators are the next step.
//
// Plain C interface (bound with ctypes); each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // key rows per tile
constexpr int NWARPS = 4;   // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the reference's mask value, not -inf

struct Strides {
  long long b, h, t;  // in elements; the last dimension is contiguous
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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

// Row pitches (in elements) of the shared-memory tiles. bf16 rows are padded
// by 16 bytes against bank conflicts and to keep wmma's 32-byte alignment.
// The f32 instantiation is unpadded and lets P/dS share the f32 score
// buffers, which is what fits its D=128 dk/dv kernel into 227 KB.
template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LDT = D + (kF32 ? 0 : 8);   // staged Q/K/V/dO tiles (T)
  static constexpr int LDS = BK + 4;               // score tiles (f32)
  static constexpr int LDP = kF32 ? LDS : BK + 8;  // P / dS tiles (T)
  static constexpr int LDA = D + (kF32 ? 0 : 4);   // output accumulators (f32)
  static constexpr size_t TILE = sizeof(T) * BQ * LDT;
  static constexpr size_t SCORE = 4 * BQ * LDS;
  static constexpr size_t PROB = kF32 ? 0 : sizeof(T) * BQ * LDP;
  static constexpr size_t ACC = 4 * BQ * LDA;
};

// ---------------------------------------------------------------------------
// Warp-level products over shared memory: 16 output rows per warp.
// ---------------------------------------------------------------------------

template <typename T>
struct WarpMma;

template <>
struct WarpMma<bf16> {
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  // C[16][N] = A[16][K] . B[N][K]^T
  template <int N, int K>
  static __device__ __forceinline__ void abt(const bf16* A, int lda, const bf16* B, int ldb,
                                             float* C, int ldc) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      FragC c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int k = 0; k < K / 16; ++k) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, A + k * 16, lda);
        wmma::load_matrix_sync(b, B + n * 16 * ldb + k * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n * 16, c, ldc, wmma::mem_row_major);
    }
  }

  // C[16][N] += A[16][K] . B[K][N]
  template <int N, int K>
  static __device__ __forceinline__ void ab_acc(const bf16* A, int lda, const bf16* B, int ldb,
                                                float* C, int ldc) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      FragC c;
      wmma::load_matrix_sync(c, C + n * 16, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < K / 16; ++k) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, A + k * 16, lda);
        wmma::load_matrix_sync(b, B + k * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n * 16, c, ldc, wmma::mem_row_major);
    }
  }

  // C[16][N] += A^T . B, where A is stored [K][lda] (16 columns used) and B is [K][N]
  template <int N, int K>
  static __device__ __forceinline__ void atb_acc(const bf16* A, int lda, const bf16* B, int ldb,
                                                 float* C, int ldc) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      FragC c;
      wmma::load_matrix_sync(c, C + n * 16, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < K / 16; ++k) {
        FragAT a;
        FragB b;
        wmma::load_matrix_sync(a, A + k * 16 * lda, lda);
        wmma::load_matrix_sync(b, B + k * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n * 16, c, ldc, wmma::mem_row_major);
    }
  }
};

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
    for (int e = 0; e < VEC; ++e) pack[e] = from_f<T>(sm[r * LD + c + e] * mul);
    *reinterpret_cast<uint4*>(g + (row0 + r) * st + c) = *reinterpret_cast<const uint4*>(pack);
  }
}

// ---------------------------------------------------------------------------
// K1: forward. Grid (q-tiles, H, B); block = one 64-row query tile.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  using C = Cfg<T, D>;
  static constexpr size_t q = 0, k = q + C::TILE, v = k + C::TILE, s = v + C::TILE;
  static constexpr size_t p = s + C::SCORE, acc = p + C::PROB, m = acc + C::ACC;
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
  T* sP = reinterpret_cast<T*>(smem + (C::kF32 ? L::s : L::p));
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
        sP[r * C::LDP + lane + 32 * half] = from_f<T>(p);
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
    WarpMma<T>::template ab_acc<D, BK>(sP + r0 * C::LDP, C::LDP, sV, C::LDT, sAcc + r0 * C::LDA,
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
// K2: dq. Grid (q-tiles, H, B); block = one 64-row query tile.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  using C = Cfg<T, D>;
  static constexpr size_t q = 0, dO = q + C::TILE, k = dO + C::TILE, v = k + C::TILE;
  static constexpr size_t s = v + C::TILE, dp = s + C::SCORE, ds = dp + C::SCORE;
  static constexpr size_t acc = ds + C::PROB, lse = acc + C::ACC, delta = lse + 4 * BQ;
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
  T* sDS = reinterpret_cast<T*>(smem + (C::kF32 ? L::dp : L::ds));
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
      sDS[r * C::LDP + c] = from_f<T>(ds);
    }
    __syncwarp();
    WarpMma<T>::template ab_acc<D, BK>(sDS + r0 * C::LDP, C::LDP, sK, C::LDT,
                                        sAcc + r0 * C::LDA, C::LDA);
    __syncthreads();
  }
  store_tile<T, D>(dq, sdq.t, sAcc, scale, iq * BQ, Tq);
}

// ---------------------------------------------------------------------------
// K3: dk and dv. Grid (k-tiles, H, B); block = one 64-row key tile that walks
// the query tiles from the first one its keys are visible to.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using C = Cfg<T, D>;
  static constexpr size_t k = 0, v = k + C::TILE, q = v + C::TILE, dO = q + C::TILE;
  static constexpr size_t s = dO + C::TILE, dp = s + C::SCORE, p = dp + C::SCORE;
  static constexpr size_t ds = p + C::PROB, dk = ds + C::PROB, dv = dk + C::ACC;
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
  T* sP = reinterpret_cast<T*>(smem + (C::kF32 ? L::s : L::p));
  T* sDS = reinterpret_cast<T*>(smem + (C::kF32 ? L::dp : L::ds));
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
      sP[r * C::LDP + c] = from_f<T>(p);
      sDS[r * C::LDP + c] = from_f<T>(ds);
    }
    __syncthreads();
    // ... and key rows here: dV += P^T dO, dK += dS^T Q.
    WarpMma<T>::template atb_acc<D, BQ>(sP + r0, C::LDP, sDO, C::LDT, sDV + r0 * C::LDA, C::LDA);
    WarpMma<T>::template atb_acc<D, BQ>(sDS + r0, C::LDP, sQ, C::LDT, sDK + r0 * C::LDA, C::LDA);
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

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, Strides sq,
                Strides sk, Strides sv, Strides so, int B, int H, int Tq, int Tk, float scale,
                int causal, cudaStream_t stream) {
  const size_t smem = FwdSmem<T, D>::bytes;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, sv, so, H, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* dq, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdq, int B, int H, int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
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

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                const void* delta, void* dk, void* dv, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdk, Strides sdv, int B, int H, int Tq, int Tk, float scale,
                int causal, cudaStream_t stream) {
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
