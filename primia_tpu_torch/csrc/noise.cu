// Gaussian noise added in one pass for Hopper: out = x + sigma * N(0, 1),
// with the normal draws made inside the kernel, so no noise tensor exists.
//
// Bound to Python through the plain C launcher at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_kernels.py, which also holds its plain PyTorch
// version).
//
// gaussian_noise_kernel (K5)
//   Replaces the TPU kernel primia_tpu/ops/pallas_kernels.py:_noise_kernel
//   (pallas_call in add_gaussian_noise_pallas). The TPU kernel seeds the
//   core's hardware generator with (seed, row); Hopper has none, so each
//   element runs a counter-based Philox-4x32-10 with key (seed, row) and
//   counter (element index in the row, 0, 0, 0), and takes its first two
//   words as the TPU kernel takes its two draws. From there it is the TPU
//   kernel's Box-Muller: uniforms from the top 24 bits, u1 + 1e-7 so the
//   log is finite, and the cosine branch,
//
//     n = sqrt(-2 log u1) * cos(2 pi u2),   out = x + (sigma * n) in x's type.
//
//   Every product and sum is written with __fmul_rn/__fadd_rn in the plain
//   version's order, so nvcc cannot contract them, and the words and
//   uniforms equal the plain version's bit for bit; logf, sqrtf and cosf are
//   CUDA's precise functions.
//
//   Bound: bytes or the integer multiplies. At 200 x 3 x 224 x 224 float32
//   the kernel reads and writes 240.8 MB (0.072 ms at 3.35 TB/s). Philox
//   makes 20 32x32->64-bit products an element, 40 results of the 32-bit
//   multiplier, which issues 64 a clock on each of the 132 SMs: about the
//   same 0.072 ms at 1,980 MHz; the special functions (log, sqrt, cos, 16 a
//   clock an SM) take 0.022 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.2831855f;  // float(2 pi)
constexpr float INV_2_24 = 5.9604645e-08f;  // 2^-24

// Philox-4x32-10 of (counter, key); returns the first two output words.
__device__ __forceinline__ uint2 philox_two(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint2(c0, c1);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// MODE 0: out = x + sigma * n in T. MODE 1: out (float) = (u1, u2) of each
// element, interleaved, for the check against the plain version.
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
gaussian_noise_kernel(const T* __restrict__ x, void* __restrict__ out, long long n,
                      uint32_t seed, float sigma) {
  const uint32_t row = blockIdx.y;
  const long long base = (long long)row * n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x) {
    const uint2 b = philox_two((uint32_t)j, (uint32_t)(j >> 32), seed, row);
    const float u1 = __fadd_rn(__fmul_rn((float)(b.x >> 8), INV_2_24), 1e-7f);
    const float u2 = __fmul_rn((float)(b.y >> 8), INV_2_24);
    if (MODE == 1) {
      float* o = (float*)out + 2 * (base + j);
      o[0] = u1;
      o[1] = u2;
    } else {
      const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
      const float nrm = __fmul_rn(r, cosf(__fmul_rn(TWO_PI, u2)));
      T noise;
      from_float(__fmul_rn(sigma, nrm), &noise);
      from_float(__fadd_rn(to_float(x[base + j]), to_float(noise)), (T*)out + base + j);
    }
  }
}

template <typename T, int MODE>
int launch(const void* x, void* out, int rows, long long n, uint32_t seed, float sigma,
           cudaStream_t s) {
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gaussian_noise_kernel<T, MODE><<<dim3((unsigned)blocks, rows), 256, 0, s>>>(
      (const T*)x, out, n, seed, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (rows, n) contiguous, dtype 0 = float32, 1 = bfloat16; rows at
// most 65,535. seed: the stream's key word (the row is the other).
int gaussian_noise(const void* x, void* out, int rows, long long n, int dtype, unsigned seed,
                   float sigma, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float, 0>(x, out, rows, n, seed, sigma, s)
                    : launch<__nv_bfloat16, 0>(x, out, rows, n, seed, sigma, s);
}

// out: (rows, n, 2) float32, the (u1, u2) each element of a (rows, n)
// input would draw under seed.
int gaussian_noise_uniforms(void* out, int rows, long long n, unsigned seed, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0) return (int)cudaErrorInvalidValue;
  return launch<float, 1>(nullptr, out, rows, n, seed, 0.0f, (cudaStream_t)stream);
}

const char* noise_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
