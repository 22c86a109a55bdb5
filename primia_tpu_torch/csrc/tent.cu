// The augmentation warps' resamplers for Hopper: a 1-D lerp along one axis
// (the two-pass warps) and the exact 4-tap bilinear gather.
//
// Two kernels, bound to Python through the plain C launchers at the end
// (loaded with ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_tent.py, which also holds their plain PyTorch
// versions). Both work in float32, in and out: the TPU kernels cast pixels
// to bf16 (pallas_tent.py:147, 284, 327), while the port's pixel pipeline
// stays f32 on every device. Every product and sum is written with
// __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order, so nvcc cannot
// contract them into FMAs and the kernels equal their plain versions bit
// for bit.
//
// Layout: planes (N, H, W) f32 with N = B*C, the C channel planes of image b
// at rows b*C .. b*C+C-1; coordinate fields (B, Ho, Wo) f32 are shared by
// the C planes of an image.
//
// tent_rows_kernel (K1)
//   Replaces the TPU kernel primia_tpu/ops/pallas_tent.py:_rows_kernel
//   (pallas_call in _resample_rows), which its two callers,
//   warp_affine_shear_pallas and warp_dense_twopass_pallas, run on the
//   image and on its transpose. Here an `along_h` flag picks the axis
//   instead of materialising the transposes:
//     row form    out[n,i,j] = v(i, k0)(1-f) + v(i, k0+1) f,  q = qs[b,i,j]
//     column form out[n,i,j] = v(k0, j)(1-f) + v(k0+1, j) f,  q = ps[b,i,j]
//   with k0 = floor(q), f = q - k0 and v = 0 outside the plane, which gives
//   zero fill outside [-1, L] (L = W or H), the TPU kernel's contract.
//   The design is K2's (below): a thread owns PIX output pixels of one
//   image, BLOCK apart, so that every load and store of a warp is one
//   contiguous run. It reads each pixel's q once and computes the clamped
//   floor, the fraction and the two taps' validity once, then walks the
//   image's planes: two taps and one store a plane. The row form's taps
//   lie in the output row, next to j; the column form's lie in two rows at
//   column j, so neighbouring lanes read neighbouring columns and the loads
//   stay coalesced where the field is smooth. The grid is (pixel blocks,
//   images, groups of CH_GROUP planes).
//   Bound: memory. At the canonical shape (200 images x 3 channels of
//   224x224) a pass reads 120.4 MB of planes and 40.1 MB of coordinates and
//   writes 120.4 MB, each once: 0.084 ms at 3.35 TB/s. PERF.md, section 6,
//   gives its time on the card beside the old design's and grid_sample's.
//
// tent_bilinear_kernel (K2): its note is above the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int PIX = 2;       // output pixels a thread (K1 and K2)
constexpr int CH_GROUP = 4;  // planes a thread walks, at most

__device__ __forceinline__ int clamp_tap(float k0, int L) {
  // taps at -2/-1 or L+1/L+2 are both outside the plane, so clamping the
  // floor to [-2, L+1] keeps the result and keeps the int conversion defined
  return (int)fminf(fmaxf(k0, -2.0f), (float)L + 1.0f);
}

// tent_rows_kernel (K1): its note is at the top of the file.
__global__ void __launch_bounds__(BLOCK)
tent_rows_kernel(const float* __restrict__ planes, const float* __restrict__ q,
                 float* __restrict__ out, int C, int H, int W, int along_h) {
  const int b = blockIdx.y;
  const int HW = H * W;
  const int p0 = blockIdx.x * (BLOCK * PIX) + threadIdx.x;  // the first pixel, in the image
  const float* q_b = q + (long long)b * HW;
  const int L = along_h ? H : W;
  const int step = along_h ? W : 1;  // from the first tap to the second
  int off[PIX];         // the first tap's offset in a plane: read only where it is valid
  unsigned valid[PIX];  // bit 0: the first tap, bit 1: the second; 0 past the end
  float f[PIX], one_f[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int p = p0 + k * BLOCK;
    const float qq = p < HW ? __ldg(q_b + p) : 0.0f;
    const float k0f = floorf(qq);
    f[k] = __fsub_rn(qq, k0f);
    one_f[k] = __fsub_rn(1.0f, f[k]);
    const int k0 = clamp_tap(k0f, L);
    const int i = p / W;
    const int j = p - i * W;
    off[k] = along_h ? k0 * W + j : i * W + k0;
    valid[k] = p < HW ? (unsigned)(k0 >= 0 && k0 < L) | (unsigned)(k0 + 1 >= 0 && k0 + 1 < L) << 1
                      : 0u;
  }

  const int c_end = min(C, (int)(blockIdx.z + 1) * CH_GROUP);
  for (int c = blockIdx.z * CH_GROUP; c < c_end; ++c) {
    const long long n = (long long)b * C + c;
    const float* plane = planes + n * HW;
    float* o = out + n * HW;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const float* t = plane + off[k];
      const float v0 = (valid[k] & 1u) ? __ldg(t) : 0.0f;
      const float v1 = (valid[k] & 2u) ? __ldg(t + step) : 0.0f;
      const int p = p0 + k * BLOCK;
      if (p < HW) o[p] = __fadd_rn(__fmul_rn(v0, one_f[k]), __fmul_rn(v1, f[k]));
    }
  }
}

// tent_bilinear_kernel (K2)
//   Replaces primia_tpu/ops/pallas_tent.py:_tent_kernel (pallas_call in
//   resample_tent_pallas): exact bilinear sampling at absolute (ys, xs),
//   zero fill per tap, the function of primia_tpu/ops/image.py:
//   bilinear_sample that the TPU kernel's bf16 tent contraction
//   approximates. On Hopper it is a 4-tap gather: the TPU's W-wide tent
//   matmul per output pixel (and its max_dy row band, which only saved MACs)
//   has no counterpart.
//   A thread owns PIX output pixels of one image, BLOCK apart, so that the
//   lanes of a warp hold neighbouring pixels and every load and store of a
//   warp is one contiguous run (or, for a gather, a few neighbouring runs
//   where the field is smooth). It reads each pixel's ys and xs once and
//   computes its clamped taps, their validity and its two weights once,
//   then walks the image's planes: four gathered taps a pixel through the
//   read-only path and one store a plane. The grid is (pixel blocks, images,
//   groups of CH_GROUP planes). The kernel this one replaced ran one block
//   per output row of each plane: every plane re-read its image's
//   coordinates (C times their bytes) and recomputed the taps.
//   Bound: memory. At the canonical shape it reads 120.4 MB of planes and
//   80.3 MB of coordinates and writes 120.4 MB, each once: 0.096 ms at
//   3.35 TB/s. PERF.md, section 6, gives its time on the card (NVIDIA H100
//   80GB HBM3, 700 W) beside the old design's 0.22-0.27 ms and
//   grid_sample's 0.136 ms.

__global__ void __launch_bounds__(BLOCK)
tent_bilinear_kernel(const float* __restrict__ planes, const float* __restrict__ ys,
                     const float* __restrict__ xs, float* __restrict__ out, int C, int H,
                     int W, int HoWo) {
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * (BLOCK * PIX) + threadIdx.x;  // the first pixel, in the image
  const float* ys_b = ys + (long long)b * HoWo;
  const float* xs_b = xs + (long long)b * HoWo;
  int off[PIX];         // y0 * W + x0: read only where a tap is valid
  unsigned valid[PIX];  // bit 0: (y0, x0), 1: (y0, x1), 2: (y1, x0), 3: (y1, x1); 0 past the end
  float wx[PIX], wy[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int q = q0 + i * BLOCK;
    const float y = q < HoWo ? __ldg(ys_b + q) : 0.0f;
    const float x = q < HoWo ? __ldg(xs_b + q) : 0.0f;
    const float y0f = floorf(y);
    const float x0f = floorf(x);
    wy[i] = __fsub_rn(y, y0f);
    wx[i] = __fsub_rn(x, x0f);
    const int y0 = clamp_tap(y0f, H);
    const int x0 = clamp_tap(x0f, W);
    const bool r0 = y0 >= 0 && y0 < H, r1 = y0 + 1 >= 0 && y0 + 1 < H;
    const bool c0 = x0 >= 0 && x0 < W, c1 = x0 + 1 >= 0 && x0 + 1 < W;
    off[i] = y0 * W + x0;
    valid[i] = q < HoWo ? (unsigned)(r0 && c0) | (unsigned)(r0 && c1) << 1 |
                              (unsigned)(r1 && c0) << 2 | (unsigned)(r1 && c1) << 3
                        : 0u;
  }

  const int c_end = min(C, (int)(blockIdx.z + 1) * CH_GROUP);
  for (int c = blockIdx.z * CH_GROUP; c < c_end; ++c) {
    const long long n = (long long)b * C + c;
    const float* plane = planes + n * H * W;
    float* o = out + n * HoWo;
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const float* p = plane + off[i];
      const float v00 = (valid[i] & 1u) ? __ldg(p) : 0.0f;
      const float v01 = (valid[i] & 2u) ? __ldg(p + 1) : 0.0f;
      const float v10 = (valid[i] & 4u) ? __ldg(p + W) : 0.0f;
      const float v11 = (valid[i] & 8u) ? __ldg(p + W + 1) : 0.0f;
      const float one_wx = __fsub_rn(1.0f, wx[i]);
      const float one_wy = __fsub_rn(1.0f, wy[i]);
      const float top = __fadd_rn(__fmul_rn(v00, one_wx), __fmul_rn(v01, wx[i]));
      const float bot = __fadd_rn(__fmul_rn(v10, one_wx), __fmul_rn(v11, wx[i]));
      const int q = q0 + i * BLOCK;
      if (q < HoWo) o[q] = __fadd_rn(__fmul_rn(top, one_wy), __fmul_rn(bot, wy[i]));
    }
  }
}

}  // namespace

extern "C" {

// planes, out: (N, H, W) float32; q: (N / C, H, W) float32. along_h = 0:
// lerp along W (row form); along_h = 1: lerp along H (column form).
int tent_rows(const void* planes, const void* q, void* out, int N, int C, int H, int W,
              int along_h, void* stream) {
  const long long HW = (long long)H * W;
  if (N <= 0 || C <= 0 || N % C != 0 || H <= 0 || W <= 0 ||
      (long long)(H + 3) * (W + 3) > 0x7fffffffLL ||  // a tap's offset fits an int
      HW > 0x7fffffffLL - BLOCK * PIX || N / C > 65535 || (C + CH_GROUP - 1) / CH_GROUP > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((HW + BLOCK * PIX - 1) / (BLOCK * PIX)), N / C,
                  (C + CH_GROUP - 1) / CH_GROUP);
  tent_rows_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)q, (float*)out, C, H, W, along_h);
  return (int)cudaGetLastError();
}

// planes: (N, H, W) float32; ys, xs: (N / C, Ho, Wo) float32; out: (N, Ho, Wo).
int tent_bilinear(const void* planes, const void* ys, const void* xs, void* out, int N,
                  int C, int H, int W, int Ho, int Wo, void* stream) {
  const long long HoWo = (long long)Ho * Wo;
  if (N <= 0 || C <= 0 || N % C != 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 ||
      (long long)(H + 3) * (W + 3) > 0x7fffffffLL ||  // a tap's offset fits an int
      HoWo > 0x7fffffffLL - BLOCK * PIX || N / C > 65535 ||
      (C + CH_GROUP - 1) / CH_GROUP > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((HoWo + BLOCK * PIX - 1) / (BLOCK * PIX)), N / C,
                  (C + CH_GROUP - 1) / CH_GROUP);
  tent_bilinear_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)ys, (const float*)xs, (float*)out, C, H, W,
      (int)HoWo);
  return (int)cudaGetLastError();
}

const char* tent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
