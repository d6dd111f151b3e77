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
//  - K5 is acc + w * float(bits << 16) in f32, multiply and add each rounded
//    (__fmul_rn / __fadd_rn: no contraction into an FMA), so it is bit-equal
//    to the plain PyTorch version. ``out`` may alias ``acc`` (in place).
//
// What bounds them on an H100: bytes. K4 reads 4 B and writes 2 B per
// element; K5 reads 2 + 4 B and writes 4 B. At the flagship buffer
// (gpt2_small, 124,439,808 floats) that is 747 MB (~223 us at 3.35 TB/s) and
// 1.24 GB (~371 us). The design is the plain one for a streaming pass: a
// grid-stride loop, eight elements per thread per step with 16-byte vector
// loads and stores, a scalar tail for any n, no shared memory (lanes are
// independent), and a scalar loop when a pointer is not 16-byte aligned.
//
// Plain C interface (bound with ctypes); each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread per step

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t x = __float_as_uint(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return ((x >> 16) & 0x8000u) | 0x7fc0u;
  return (x + 0x7fffu + ((x >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float widen(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ float axpy(float a, float w, uint32_t bits16) {
  return __fadd_rn(a, __fmul_rn(w, widen(bits16)));
}

template <bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    bf16_encode_kernel(const float* __restrict__ x, uint16_t* __restrict__ out, int64_t n) {
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
    bf16_decode_axpy_kernel(const uint16_t* __restrict__ bits, const float* acc, float* out, float w,
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

// Enough blocks to fill every SM (8 blocks of 256 threads each), fewer when
// the work is smaller; the grid-stride loop covers the rest.
cudaError_t grid_for(int64_t n, int* blocks) {
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

}  // namespace

extern "C" {

int dvc_bf16_encode(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<uint16_t*>(out);
  if (aligned16(x) && aligned16(out)) {
    bf16_encode_kernel<true><<<blocks, kThreads, 0, s>>>(xf, o, n);
  } else {
    bf16_encode_kernel<false><<<blocks, kThreads, 0, s>>>(xf, o, n);
  }
  return cudaGetLastError();
}

int dvc_bf16_decode_axpy(const void* bits, const void* acc, void* out, float w, int64_t n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const uint16_t*>(bits);
  auto a = static_cast<const float*>(acc);
  auto o = static_cast<float*>(out);
  if (aligned16(bits) && aligned16(acc) && aligned16(out)) {
    bf16_decode_axpy_kernel<true><<<blocks, kThreads, 0, s>>>(b, a, o, w, n);
  } else {
    bf16_decode_axpy_kernel<false><<<blocks, kThreads, 0, s>>>(b, a, o, w, n);
  }
  return cudaGetLastError();
}

}  // extern "C"
