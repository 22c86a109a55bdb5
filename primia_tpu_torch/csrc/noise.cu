// Gaussian noise added in one pass for Hopper: out = x + sigma * N(0, 1),
// with the normal draws made inside the kernel, so no noise tensor exists.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_kernels.py, which also holds its plain PyTorch
// version and the launch plan).
//
// gaussian_noise_kernel (K5)
//   Replaces the TPU kernel primia_tpu/ops/pallas_kernels.py:_noise_kernel
//   (pallas_call in add_gaussian_noise_pallas). The TPU kernel seeds the
//   core's hardware generator with (seed, row) and draws two fresh words for
//   every element, of which it keeps the cosine branch of Box-Muller. Hopper
//   has no generator, so the kernel runs a counter-based Philox-4x32-10 with
//   key (seed, row), and one block serves four consecutive elements of a row:
//   group g = j >> 2 runs counter (g mod 2^32, g >> 32, 0, 0), its words
//   (w0, w1) are pair 2g and (w2, w3) pair 2g + 1, and pair p gives element
//   2p the cosine branch and element 2p + 1 the sine branch of the same
//   (u1, u2):
//
//     u1 = top24(w_even) * 2^-24 + 1e-7,   u2 = top24(w_odd) * 2^-24,
//     r = sqrt(-2 log u1),   n_2p = r cos(2 pi u2),   n_2p+1 = r sin(2 pi u2),
//     out = x + (sigma * n) in x's type.
//
//   Deviation from the TPU kernel, on purpose: both branches of one pair
//   where the TPU draws a pair an element and drops the sine. Each element is
//   still N(0, 1) and the elements are independent (the two branches of
//   Box-Muller are independent normals); the TPU's hardware bits were never
//   reproducible, so the two agree in distribution, as before.
//
//   Every product and sum is written with __fmul_rn/__fadd_rn in the plain
//   version's order, so nvcc cannot contract them, and the words and
//   uniforms equal the plain version's bit for bit; logf, sqrtf and sincosf
//   are CUDA's precise functions (__logf's absolute error near u1 = 1 would
//   move r by about 8e-4).
//
//   Bound: bytes. At 200 x 3 x 224 x 224 float32 the kernel reads and writes
//   240.8 MB, 0.072 ms at 3.35 TB/s. Its other work an element, at 1,980 MHz:
//   19 32x32->64-bit products a Philox block (round 0 multiplies a zero word),
//   9.5 results of the 32-bit multiplier (64 a clock an SM), 0.017 ms; a
//   MUFU.RSQ (sqrtf) and an F2I (sincosf's quadrant) a pair on the 16-a-clock
//   unit, 0.007 ms; and 66.25 issued instructions (265 a group on the vector
//   path of the SASS listing), at 4 x 32 a clock an SM 0.060 ms, so the math
//   fits under the bytes only if it overlaps them. chip_smoke.py (phase 11)
//   computes each term and checks the SASS against its counts.
//
//   Design: a thread takes a (row, group) of a flat index space in a grid
//   stride, the grid one wave of the blocks the card holds at once (the
//   occupancy API, through the wrapper's plan); __launch_bounds__ holds it to
//   32 registers, so 2,048 threads an SM keep loads in flight. A thread
//   issues the load of its x group (one 16-byte float4, or 8 bytes of bf16)
//   before the Philox rounds, so the math hides the load, and stores the
//   group in one access; both carry the evict-first hint (each byte is read
//   or written once). A row whose base is off the access's alignment
//   (n % 4 != 0) and a row's ragged last group take scalar accesses; the
//   element-to-word mapping is the same, so the bits do not depend on the
//   path. Indices within a row are 32-bit (n < 2^31); a row's base is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads an SM: at most 32 registers a thread
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.2831855f;  // float(2 pi)
constexpr float INV_2_24 = 5.9604645e-08f;  // 2^-24

// Philox-4x32-10 of counter (c0, c1, 0, 0) under key (k0, k1): all four words.
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint64_t p0 = (uint64_t)PHILOX_M0 * c0, p1 = (uint64_t)PHILOX_M1 * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0, n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c0 = n0;
    c1 = (uint32_t)p1;
    c2 = n2;
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// (u1, u2) of a pair from its two words.
__device__ __forceinline__ float2 uniforms(uint32_t a, uint32_t b) {
  return make_float2(__fadd_rn(__fmul_rn((float)(a >> 8), INV_2_24), 1e-7f),
                     __fmul_rn((float)(b >> 8), INV_2_24));
}

// Both Box-Muller branches of one pair: one log, one sqrt, one sincos.
__device__ __forceinline__ void box_muller(float2 u, float* z) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u.x)));
  float s, c;
  sincosf(__fmul_rn(TWO_PI, u.y), &s, &c);
  z[0] = __fmul_rn(r, c);
  z[1] = __fmul_rn(r, s);
}

// A group of four elements of T as one access: float4, or 8 bytes of bf16.
template <typename T>
struct Group;

template <>
struct Group<float> {
  using Vec = float4;
  __device__ static float to_float(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  __device__ static void unpack(float4 v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static float4 pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <>
struct Group<__nv_bfloat16> {
  using Vec = uint2;
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
  __device__ static void unpack(uint2 v, float* f) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xFFFF0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
  __device__ static uint32_t two(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint2 pack(const float* f) { return make_uint2(two(f[0], f[1]), two(f[2], f[3])); }
};

// MODE 0: out = x + sigma * n in T. MODE 1: out (float) = (u1, u2) of each
// element, interleaved, for the check against the plain version.
// (rows, n) is walked as rows * groups items (groups = ceil(n / 4)); thread
// t starts at item t and steps by the grid's threads, step_rows rows and
// step_groups groups at a time.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gaussian_noise_kernel(const T* __restrict__ x, void* __restrict__ out, uint32_t rows, uint32_t n,
                      uint32_t groups, uint32_t step_rows, uint32_t step_groups, uint32_t seed,
                      float sigma) {
  using G = Group<T>;
  using Vec = typename G::Vec;
  const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
  uint32_t row = t / groups, g = t - row * groups;
#pragma unroll 1
  while (row < rows) {
    const size_t base = (size_t)row * n;
    const uint32_t j = 4u * g;
    if (MODE == 1) {
      const uint4 w = philox4(g, 0u, seed, row);  // g < 2^32: the counter's second word is 0
      const float2 u[2] = {uniforms(w.x, w.y), uniforms(w.z, w.w)};
      float2* o = (float2*)out + base + j;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < n) o[e] = u[e >> 1];
    } else {
      const T* xr = x + base + j;
      T* orow = (T*)out + base + j;
      const bool vec = j + 4 <= n && (((uintptr_t)xr | (uintptr_t)orow) % sizeof(Vec)) == 0;
      float xs[4];
      if (vec) {
        G::unpack(__ldcs(reinterpret_cast<const Vec*>(xr)), xs);  // read once: evict first
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[e] = j + e < n ? G::to_float(xr[e]) : 0.0f;
      }
      const uint4 w = philox4(g, 0u, seed, row);
      float z[4], ys[4];
      box_muller(uniforms(w.x, w.y), z);
      box_muller(uniforms(w.z, w.w), z + 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) ys[e] = __fadd_rn(xs[e], G::round(__fmul_rn(sigma, z[e])));
      if (vec) {
        __stcs(reinterpret_cast<Vec*>(orow), G::pack(ys));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < n) orow[e] = G::from_float(ys[e]);
      }
    }
    g += step_groups;
    row += step_rows;
    if (g >= groups) {
      g -= groups;
      ++row;
    }
  }
}

bool plan_ok(unsigned rows, unsigned n, unsigned grid, unsigned groups, unsigned step_rows,
             unsigned step_groups) {
  if (rows == 0 || rows > 65535 || n == 0 || n >= (1u << 31) || grid == 0) return false;
  // step_rows past rows + 256 would be a grid beyond the items (and could wrap row)
  if (groups != (n + 3) / 4 || step_groups >= groups || step_rows > rows + 256) return false;
  const unsigned long long step = (unsigned long long)grid * THREADS;
  return step < (1ull << 32) && step == (unsigned long long)step_rows * groups + step_groups;
}

template <typename T, int MODE>
int launch(const void* x, void* out, unsigned rows, unsigned n, unsigned seed, float sigma,
           unsigned grid, unsigned groups, unsigned step_rows, unsigned step_groups,
           cudaStream_t s) {
  gaussian_noise_kernel<T, MODE><<<grid, THREADS, 0, s>>>(
      (const T*)x, out, rows, n, groups, step_rows, step_groups, seed, sigma);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gaussian_noise_kernel<T, MODE>, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" {

// Blocks of the kernel (dtype 0 = float32, 1 = bfloat16; mode 0 = noise,
// 1 = uniforms) an SM holds at once; < 0: a CUDA error, negated.
int gaussian_noise_blocks_per_sm(int dtype, int mode) {
  if (mode == 1) return blocks_per_sm<float, 1>();
  if (dtype == 0) return blocks_per_sm<float, 0>();
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16, 0>();
  return -(int)cudaErrorInvalidValue;
}

// x, out: (rows, n) contiguous, dtype 0 = float32, 1 = bfloat16; rows at
// most 65,535, n below 2^31. seed: the stream's key word (the row is the
// other). The plan (grid blocks of 256 threads; groups = ceil(n / 4); the
// grid's threads as step_rows * groups + step_groups) comes from the wrapper.
int gaussian_noise(const void* x, void* out, unsigned rows, unsigned n, int dtype, unsigned seed,
                   float sigma, unsigned grid, unsigned groups, unsigned step_rows,
                   unsigned step_groups, void* stream) {
  if (!plan_ok(rows, n, grid, groups, step_rows, step_groups) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float, 0>(x, out, rows, n, seed, sigma, grid, groups, step_rows,
                                       step_groups, s)
                    : launch<__nv_bfloat16, 0>(x, out, rows, n, seed, sigma, grid, groups,
                                               step_rows, step_groups, s);
}

// out: (rows, n, 2) float32, the (u1, u2) each element of a (rows, n)
// input would draw under seed; the plan as above, for mode 1.
int gaussian_noise_uniforms(void* out, unsigned rows, unsigned n, unsigned seed, unsigned grid,
                            unsigned groups, unsigned step_rows, unsigned step_groups,
                            void* stream) {
  if (!plan_ok(rows, n, grid, groups, step_rows, step_groups)) return (int)cudaErrorInvalidValue;
  return launch<float, 1>(nullptr, out, rows, n, seed, 0.0f, grid, groups, step_rows,
                          step_groups, (cudaStream_t)stream);
}

const char* noise_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
