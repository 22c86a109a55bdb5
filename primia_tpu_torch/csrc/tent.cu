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
// the C planes of an image. One block per output row of a plane (the grid
// runs over planes x rows), one thread per output pixel in turn, so
// neighbouring threads write neighbouring pixels.
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
//   zero fill outside [-1, L] (L = W or H), the TPU kernel's contract. In
//   the column form neighbouring threads read neighbouring columns of the
//   two source rows, so the loads stay coalesced where the field is smooth.
//   Bound: memory. At the canonical shape (200 images x 3 channels of
//   224x224) a pass reads 120.4 MB of planes and 40.1 MB of coordinates and
//   writes 120.4 MB: 0.084 ms at 3.35 TB/s. Each input byte is read about
//   once (the second tap of a row hits the same cache line).
//
// tent_bilinear_kernel (K2)
//   Replaces primia_tpu/ops/pallas_tent.py:_tent_kernel (pallas_call in
//   resample_tent_pallas): exact bilinear sampling at absolute (ys, xs),
//   zero fill per tap, the function of primia_tpu/ops/image.py:
//   bilinear_sample that the TPU kernel's bf16 tent contraction
//   approximates. On Hopper it is a 4-tap gather: the TPU's W-wide tent
//   matmul per output pixel (and its max_dy row band, which only saved MACs)
//   has no counterpart.
//   Bound: memory. At the canonical shape it reads 120.4 MB of planes and
//   80.3 MB of coordinates and writes 120.4 MB: 0.096 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_tap(float k0, int L) {
  // taps at -2/-1 or L+1/L+2 are both outside the plane, so clamping the
  // floor to [-2, L+1] keeps the result and keeps the int conversion defined
  return (int)fminf(fmaxf(k0, -2.0f), (float)L + 1.0f);
}

__global__ void __launch_bounds__(256)
tent_rows_kernel(const float* __restrict__ planes, const float* __restrict__ q,
                 float* __restrict__ out, int C, int H, int W, int along_h) {
  const long long row = blockIdx.x;  // n * H + i
  const long long n = row / H;
  const int i = (int)(row - n * H);
  const long long b = n / C;
  const float* plane = planes + n * H * W;
  const float* q_row = q + (b * H + i) * W;
  float* out_row = out + row * W;
  const int L = along_h ? H : W;

  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const float qq = q_row[j];
    const float k0f = floorf(qq);
    const float f = __fsub_rn(qq, k0f);
    const int k0 = clamp_tap(k0f, L);
    const int k1 = k0 + 1;
    float v0 = 0.0f, v1 = 0.0f;
    if (along_h) {
      if (k0 >= 0 && k0 < L) v0 = plane[(long long)k0 * W + j];
      if (k1 >= 0 && k1 < L) v1 = plane[(long long)k1 * W + j];
    } else {
      const float* src = plane + (long long)i * W;
      if (k0 >= 0 && k0 < L) v0 = src[k0];
      if (k1 >= 0 && k1 < L) v1 = src[k1];
    }
    out_row[j] = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, f)), __fmul_rn(v1, f));
  }
}

__global__ void __launch_bounds__(256)
tent_bilinear_kernel(const float* __restrict__ planes, const float* __restrict__ ys,
                     const float* __restrict__ xs, float* __restrict__ out, int C,
                     int H, int W, int Ho, int Wo) {
  const long long row = blockIdx.x;  // n * Ho + i
  const long long n = row / Ho;
  const int i = (int)(row - n * Ho);
  const long long b = n / C;
  const float* plane = planes + n * H * W;
  const long long coord0 = (b * Ho + i) * Wo;
  float* out_row = out + row * Wo;

  for (int j = threadIdx.x; j < Wo; j += blockDim.x) {
    const float y = ys[coord0 + j];
    const float x = xs[coord0 + j];
    const float y0f = floorf(y);
    const float x0f = floorf(x);
    const float wy = __fsub_rn(y, y0f);
    const float wx = __fsub_rn(x, x0f);
    const int y0 = clamp_tap(y0f, H);
    const int x0 = clamp_tap(x0f, W);
    const int y1 = y0 + 1;
    const int x1 = x0 + 1;
    const bool r0 = y0 >= 0 && y0 < H, r1 = y1 >= 0 && y1 < H;
    const bool c0 = x0 >= 0 && x0 < W, c1 = x1 >= 0 && x1 < W;
    const float v00 = (r0 && c0) ? plane[(long long)y0 * W + x0] : 0.0f;
    const float v01 = (r0 && c1) ? plane[(long long)y0 * W + x1] : 0.0f;
    const float v10 = (r1 && c0) ? plane[(long long)y1 * W + x0] : 0.0f;
    const float v11 = (r1 && c1) ? plane[(long long)y1 * W + x1] : 0.0f;
    const float one_wx = __fsub_rn(1.0f, wx);
    const float one_wy = __fsub_rn(1.0f, wy);
    const float top = __fadd_rn(__fmul_rn(v00, one_wx), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, one_wx), __fmul_rn(v11, wx));
    out_row[j] = __fadd_rn(__fmul_rn(top, one_wy), __fmul_rn(bot, wy));
  }
}

int threads_for(int width) {
  const int t = ((width + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" {

// planes, out: (N, H, W) float32; q: (N / C, H, W) float32. along_h = 0:
// lerp along W (row form); along_h = 1: lerp along H (column form).
int tent_rows(const void* planes, const void* q, void* out, int N, int C, int H, int W,
              int along_h, void* stream) {
  const long long blocks = (long long)N * H;
  if (N <= 0 || C <= 0 || N % C != 0 || H <= 0 || W <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tent_rows_kernel<<<(unsigned)blocks, threads_for(W), 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)q, (float*)out, C, H, W, along_h);
  return (int)cudaGetLastError();
}

// planes: (N, H, W) float32; ys, xs: (N / C, Ho, Wo) float32; out: (N, Ho, Wo).
int tent_bilinear(const void* planes, const void* ys, const void* xs, void* out, int N,
                  int C, int H, int W, int Ho, int Wo, void* stream) {
  const long long blocks = (long long)N * Ho;
  if (N <= 0 || C <= 0 || N % C != 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tent_bilinear_kernel<<<(unsigned)blocks, threads_for(Wo), 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)ys, (const float*)xs, (float*)out, C, H, W, Ho,
      Wo);
  return (int)cudaGetLastError();
}

const char* tent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
