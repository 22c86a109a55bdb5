// CLAHE (contrast-limited adaptive histogram equalisation) for Hopper.
//
// Two kernels, bound to Python through the plain C launchers at the end
// (loaded with ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_clahe.py, which also holds their plain
// PyTorch versions).
//
// clahe_lut_kernel
//   Replaces the TPU kernel primia_tpu/ops/pallas_clahe.py:_lut_kernel
//   (pallas_call in _lut_stage). One block per (plane, tile), 256
//   threads, one thread per histogram bin. The tile's pixels are counted
//   into a shared int[256] with shared-memory atomics; pixels past the
//   image edge are read clamped, which is the reference's "edge" padding.
//   Then: clip at `limit`, a block reduction of the excess, spread it
//   evenly (h = min(h, limit) + excess/256), an inclusive scan over the
//   bins and lut = clip(rint(cdf / P * 255), 0, 255). With clip_limit 1
//   every value is a multiple of 2^-12 below 2^10 at 224 px (28x28
//   tiles), so the f32 sums are exact in any order and the LUTs equal the
//   plain version bit for bit.
//   Bound: memory. It reads every pixel once and writes N*T*T*256 f32:
//   at 64 planes of 224x224 about 3.2 MB in and 4.2 MB out, 2.2 us at
//   3.35 TB/s; launch latency dominates at that size. The design keeps
//   the histogram in shared memory, so device memory sees one read of
//   the pixels and one write of the LUTs and nothing else.
//
// clahe_apply_kernel
//   Replaces primia_tpu/ops/pallas_clahe.py:_apply_kernel (pallas_call in
//   _clahe_pallas_impl). One block per (plane, band of rows), one thread
//   per output pixel in turn. The plane's LUTs are staged in shared
//   memory as uint8 (exact: the entries are integers in [0, 255]; 16 KB
//   for an 8x8 grid), so each of the four corner lookups is a shared
//   memory gather. Weights and the mix follow the reference's gather
//   path (primia_tpu/ops/image.py:_clahe_channels): fy = (y - th/2)/th,
//   clamped tile indices, weights clipped to [0, 1],
//   top = v00(1-wx) + v01 wx, bot = v10(1-wx) + v11 wx,
//   out = top(1-wy) + bot wy, each product and sum rounded on its own
//   (__fmul_rn/__fadd_rn keep the compiler from contracting them into
//   FMAs, which would round differently from the plain version).
//   Bound: memory. It reads the pixels and the f32 LUTs and writes f32:
//   at 64 planes of 224x224 about 3.2 + 4.2 MB in and 12.8 MB out, 6 us
//   at 3.35 TB/s. Reads and writes are coalesced along rows; the LUTs are
//   read from device memory once per block (L2-resident after the first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__global__ void __launch_bounds__(kBins)
clahe_lut_kernel(const uint8_t* __restrict__ planes, float* __restrict__ luts,
                 int H, int W, int T, int th, int tw, float limit) {
  __shared__ int hist[kBins];
  __shared__ float warp_part[kBins / 32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tiles2 = T * T;
  const long long n = blockIdx.x / tiles2;
  const int tile = blockIdx.x % tiles2;
  const int y0 = (tile / T) * th;
  const int x0 = (tile % T) * tw;
  const int P = th * tw;
  const uint8_t* plane = planes + n * H * W;

  hist[t] = 0;
  __syncthreads();
  for (int p = t; p < P; p += kBins) {
    const int y = min(y0 + p / tw, H - 1);
    const int x = min(x0 + p % tw, W - 1);
    atomicAdd(&hist[plane[(long long)y * W + x]], 1);
  }
  __syncthreads();

  // clip, and spread the clipped excess evenly over the bins
  const float h = (float)hist[t];
  float excess = warp_sum(fmaxf(__fsub_rn(h, limit), 0.0f));
  if (lane == 0) warp_part[warp] = excess;
  __syncthreads();
  excess = 0.0f;
#pragma unroll
  for (int w = 0; w < kBins / 32; ++w) excess = __fadd_rn(excess, warp_part[w]);
  __syncthreads();  // warp_part is reused by the scan below
  float v = __fadd_rn(fminf(h, limit), __fdiv_rn(excess, (float)kBins));

  // inclusive scan over the 256 bins: within each warp, then warp offsets
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v = __fadd_rn(v, u);
  }
  if (lane == 31) warp_part[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v = __fadd_rn(v, warp_part[w]);

  const float lut = rintf(__fmul_rn(__fdiv_rn(v, (float)P), 255.0f));
  luts[(n * tiles2 + tile) * kBins + t] = fminf(fmaxf(lut, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(256)
clahe_apply_kernel(const uint8_t* __restrict__ planes, const float* __restrict__ luts,
                   float* __restrict__ out, int H, int W, int T, int th, int tw,
                   int rows_per_block) {
  extern __shared__ uint8_t s_lut[];  // T*T*256 entries of this plane

  const long long n = blockIdx.y;
  const int lut_size = T * T * kBins;
  const float* lut_n = luts + n * lut_size;
  for (int i = threadIdx.x; i < lut_size; i += blockDim.x) {
    s_lut[i] = (uint8_t)__float2uint_rn(lut_n[i]);
  }
  __syncthreads();

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, H);
  const uint8_t* plane = planes + n * H * W;
  float* out_n = out + n * H * W;
  const float half_th = 0.5f * (float)th;
  const float half_tw = 0.5f * (float)tw;
  const int count = (r1 - r0) * W;

  for (int p = threadIdx.x; p < count; p += blockDim.x) {
    const int y = r0 + p / W;
    const int x = p % W;
    const long long idx = (long long)y * W + x;
    const int v = plane[idx];

    const float fy = __fdiv_rn(__fsub_rn((float)y, half_th), (float)th);
    const float fx = __fdiv_rn(__fsub_rn((float)x, half_tw), (float)tw);
    const int ty0 = min(max((int)floorf(fy), 0), T - 1);
    const int tx0 = min(max((int)floorf(fx), 0), T - 1);
    const int ty1 = min(ty0 + 1, T - 1);
    const int tx1 = min(tx0 + 1, T - 1);
    const float wy = fminf(fmaxf(__fsub_rn(fy, (float)ty0), 0.0f), 1.0f);
    const float wx = fminf(fmaxf(__fsub_rn(fx, (float)tx0), 0.0f), 1.0f);

    const float v00 = (float)s_lut[(ty0 * T + tx0) * kBins + v];
    const float v01 = (float)s_lut[(ty0 * T + tx1) * kBins + v];
    const float v10 = (float)s_lut[(ty1 * T + tx0) * kBins + v];
    const float v11 = (float)s_lut[(ty1 * T + tx1) * kBins + v];

    const float one_wx = __fsub_rn(1.0f, wx);
    const float one_wy = __fsub_rn(1.0f, wy);
    const float top = __fadd_rn(__fmul_rn(v00, one_wx), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, one_wx), __fmul_rn(v11, wx));
    out_n[idx] = __fadd_rn(__fmul_rn(top, one_wy), __fmul_rn(bot, wy));
  }
}

}  // namespace

extern "C" {

// planes: (N, H, W) uint8; luts: (N, T*T, 256) float32.
int clahe_lut(const void* planes, void* luts, int N, int H, int W, int T, int th,
              int tw, float limit, void* stream) {
  const long long blocks = (long long)N * T * T;
  if (N <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  clahe_lut_kernel<<<(unsigned)blocks, kBins, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (float*)luts, H, W, T, th, tw, limit);
  return (int)cudaGetLastError();
}

// planes: (N, H, W) uint8; luts: (N, T*T, 256) float32; out: (N, H, W)
// float32 in [0, 255]. One block per tile row of each plane.
int clahe_apply(const void* planes, const void* luts, void* out, int N, int H,
                int W, int T, int th, int tw, void* stream) {
  if (N <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const int smem = T * T * kBins;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows_per_block = th;
  const dim3 grid((H + rows_per_block - 1) / rows_per_block, N);
  clahe_apply_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const float*)luts, (float*)out, H, W, T, th, tw,
      rows_per_block);
  return (int)cudaGetLastError();
}

const char* clahe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
