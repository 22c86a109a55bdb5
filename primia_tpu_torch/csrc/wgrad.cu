// The weight gradient of a 3x3, stride-1, pad-1 convolution for Hopper, on
// the tensor cores (bf16 in, f32 accumulate).
//
// Bound to Python through the plain C launcher at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_wgrad.py, which also holds its plain PyTorch
// version).
//
// conv3x3_wgrad_kernel (K7)
//   Replaces the TPU kernels primia_tpu/ops/pallas_wgrad.py:_wgrad_kernel
//   (pallas_call in conv3x3_wgrad_pallas) and _wgrad_kernel_v2 (pallas_call
//   in conv3x3_wgrad_pallas_v2). The two differ only in where the TPU builds
//   its halos; here the halo is index arithmetic, so one kernel serves both.
//
//     dW[o, c, kh, kw] = sum_{b,h,w} x[b, h+kh-1, w+kw-1, c] * g[b, h, w, o]
//
//   (zero outside the image), with x (B, H, W, ci) and g (B, H, W, co) in
//   NHWC memory (channels_last NCHW tensors) and dW OIHW float32.
//
//   It keeps the TPU kernel's folding: one GEMM of M = 3*ci rows (kh folded
//   into x's channels), N = 3*co columns (kw folded into g's channels) and
//   K = B*H*W pixels,
//
//     A[kh*ci + c][p] = x[b, h+kh-1, w, c]    (0 if the row leaves the image)
//     B[p][kw*co + o] = g[b, h, w-kw+1, o]    (0 if the column leaves it)
//
//   for the pixel p = (b, h, w): shifting g by -kw instead of x by +kw is
//   what lets one pixel index serve all nine taps. Each A or B row is 8
//   contiguous channels (16 bytes) of one pixel, so a tile is gathered with
//   16-byte cp.async copies whose source size is 0 where the tap falls
//   outside the image: the zero halo costs no memory. A thread copies the
//   same 16-byte column of A and of B every step, so its tap and channel
//   are divided out once a block, and it carries its two pixels' (h, w)
//   from step to step instead of dividing again.
//
//   Tiling: a block owns a 128 x 128 tile of the (M, N) product and one
//   split of K; 8 warps of 64 x 32 each run nvcuda::wmma 16x16x16 bf16
//   fragments with f32 accumulators over 32-pixel steps, two shared-memory
//   stages deep (the next step's copies fly while this one multiplies).
//   The output is small (384 x 384 or 768 x 768 at the train step's
//   shapes) and K is long (156,800 or 39,200), so K is split across blocks:
//   each writes its partial tile to a float32 workspace, and
//   conv3x3_wgrad_reduce_kernel sums the splits in a fixed order into OIHW.
//   No atomics, so the result is deterministic.
//
//   Bound: operations. At the train step's shapes (200 x 128 x 28 x 28 and
//   200 x 256 x 14 x 14) one call is 2 * 9 * ci * co * B*H*W = 46.24 GFLOP:
//   0.0467 ms at 989 TFLOP/s (dense bf16); it moves 80 MB (0.024 ms at
//   3.35 TB/s). wmma issues mma.sync, not Hopper's wgmma, so this kernel
//   cannot reach that peak: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 128;       // rows of M (3*ci) a block owns
constexpr int BN = 128;       // columns of N (3*co) a block owns
constexpr int BK = 32;        // pixels a step
constexpr int LDS = BM + 8;   // shared row pitch in bf16: 272 bytes (a multiple of 32)
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;
constexpr int CHUNKS = BK * (BM / 8);  // 16-byte copies per operand tile
static_assert(CHUNKS == 2 * THREADS, "a thread copies two chunks of each operand a step");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_size = valid ? 16 : 0;  // 0: the copy writes 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Problem {
  const bf16* x;  // (P, ci)
  const bf16* g;  // (P, co)
  float* ws;      // (splits, Mpad, Npad)
  int H, W, ci, co, M, N, Npad;
  int P, k_chunk;  // pixels (< 2^31) and pixels a split
};

// A thread's share of every step's copies: the 16-byte chunk j of the A row
// m0 + j and of the B column n0 + j (fixed for the whole block, so the tap
// and channel are divided out once), at the pixels k and k + BK/2 of the
// step, whose (h, w) it carries from step to step without dividing.
struct Slot {
  int p, h, w;  // pixel, its row and column
};

__device__ __forceinline__ Slot slot_at(const Problem& pr, int p) {
  return Slot{p, (p / pr.W) % pr.H, p % pr.W};
}

__device__ __forceinline__ void advance(const Problem& pr, Slot& s) {
  s.p += BK;
  s.w += BK;
  while (s.w >= pr.W) {
    s.w -= pr.W;
    if (++s.h == pr.H) s.h = 0;
  }
}

struct Taps {
  int a_off, kh;       // x: channel offset and row tap of the A chunk (-1: none)
  int b_off, kw;       // g: channel offset and column tap of the B chunk (-1: none)
};

// One step's A and B tiles: A_s[k][m] = A[m0 + m][p0 + k], B_s[k][n] =
// B[p0 + k][n0 + n], zero where the tap, the pixel or the row is outside.
__device__ __forceinline__ void load_step(const Problem& pr, bf16* A_s, bf16* B_s,
                                          const Taps& tp, const Slot* sl, int k0, int j,
                                          int p_end) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const Slot& s = sl[i];
    const int k = k0 + i * (BK / 2);
    const bool in_k = s.p < p_end;
    const long long pp = s.p;
    {  // A: x at row h + kh - 1
      const int hs = s.h + tp.kh - 1;
      const bool ok = in_k && tp.kh >= 0 && hs >= 0 && hs < pr.H;
      const bf16* src = ok ? pr.x + (pp + (long long)(tp.kh - 1) * pr.W) * pr.ci + tp.a_off : pr.x;
      cp_async16(A_s + k * LDS + j, src, ok);
    }
    {  // B: g at column w - kw + 1
      const int ws = s.w - tp.kw + 1;
      const bool ok = in_k && tp.kw >= 0 && ws >= 0 && ws < pr.W;
      const bf16* src = ok ? pr.g + (pp - tp.kw + 1) * pr.co + tp.b_off : pr.g;
      cp_async16(B_s + k * LDS + j, src, ok);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_kernel(Problem pr) {
  __shared__ __align__(128) bf16 A_s[2][BK * LDS];
  __shared__ __align__(128) bf16 B_s[2][BK * LDS];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int p_beg = blockIdx.z * pr.k_chunk;
  const int p_end = min(p_beg + pr.k_chunk, pr.P);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 4) * WM;
  const int wn = (warp % 4) * WN;

  // this thread's copies: chunk j of the rows k0 and k0 + BK/2 of a step
  // (CHUNKS = 2 * THREADS: two a thread)
  const int j = (threadIdx.x % (BM / 8)) * 8;
  const int k0 = threadIdx.x / (BM / 8);
  Taps tp;
  {
    const int m = m0 + j, n = n0 + j;
    tp.kh = m < pr.M ? m / pr.ci : -1;
    tp.a_off = m < pr.M ? m - tp.kh * pr.ci : 0;
    tp.kw = n < pr.N ? n / pr.co : -1;
    tp.b_off = n < pr.N ? n - tp.kw * pr.co : 0;
  }
  Slot sl[2] = {slot_at(pr, p_beg + k0), slot_at(pr, p_beg + k0 + BK / 2)};

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j2 = 0; j2 < WN / 16; ++j2) wmma::fill_fragment(acc[i][j2], 0.0f);

  const int steps = p_end > p_beg ? (p_end - p_beg + BK - 1) / BK : 0;
  if (steps > 0) load_step(pr, A_s[0], B_s[0], tp, sl, k0, j, p_end);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) {
      advance(pr, sl[0]);
      advance(pr, sl[1]);
      load_step(pr, A_s[cur ^ 1], B_s[cur ^ 1], tp, sl, k0, j, p_end);
    }
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest has landed: step t's
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], A_s[cur] + kk * LDS + wm + i * 16, LDS);
#pragma unroll
      for (int j2 = 0; j2 < WN / 16; ++j2)
        wmma::load_matrix_sync(b[j2], B_s[cur] + kk * LDS + wn + j2 * 16, LDS);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j2 = 0; j2 < WN / 16; ++j2) wmma::mma_sync(acc[i][j2], a[i], b[j2], acc[i][j2]);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  const long long Mpad = (long long)gridDim.y * BM;
  float* out = pr.ws + (long long)blockIdx.z * Mpad * pr.Npad;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j2 = 0; j2 < WN / 16; ++j2)
      wmma::store_matrix_sync(out + (long long)(m0 + wm + i * 16) * pr.Npad + n0 + wn + j2 * 16,
                              acc[i][j2], pr.Npad, wmma::mem_row_major);
}

// dW[o, c, kh, kw] = sum over splits of ws[s][kh*ci + c][kw*co + o], in
// split order. One thread per (m, n), n fastest, so the reads coalesce.
__global__ void __launch_bounds__(256)
conv3x3_wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw, int splits,
                            int ci, int co, long long Mpad, int Npad) {
  const int M = 3 * ci, N = 3 * co;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * N) return;
  const int m = (int)(idx / N);
  const int n = (int)(idx - (long long)m * N);
  const float* src = ws + (long long)m * Npad + n;
  const long long stride = Mpad * Npad;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += src[k * stride];
  const int kh = m / ci, c = m - kh * ci;
  const int kw = n / co, o = n - kw * co;
  dw[(((long long)o * ci + c) * 3 + kh) * 3 + kw] = s;
}

}  // namespace

extern "C" {

// x: (P, ci) bf16 and g: (P, co) bf16, P = B*H*W pixels in NHWC order, both
// 16-byte aligned; ws: (splits, Mpad, Npad) float32 with Mpad and Npad the
// multiples of 128 at or above 3*ci and 3*co; dw: (co, ci, 3, 3) float32.
// Each split covers k_chunk pixels (a multiple of 32); P < 2^31.
int conv3x3_wgrad(const void* x, const void* g, void* ws, void* dw, long long P, int H, int W,
                  int ci, int co, int splits, long long k_chunk, void* stream) {
  if (P <= 0 || P > 0x7fffffffLL - 2 * BK || H <= 0 || W <= 0 ||
      P % ((long long)H * W) != 0 || ci <= 0 || co <= 0 || ci % 8 != 0 || co % 8 != 0 ||
      splits <= 0 || splits > 65535 || k_chunk <= 0 || k_chunk % BK != 0 ||
      k_chunk * splits < P || k_chunk * (splits - 1) >= P)
    return (int)cudaErrorInvalidValue;
  const int M = 3 * ci, N = 3 * co;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  Problem pr{(const bf16*)x, (const bf16*)g, (float*)ws, H, W, ci, co, M, N, nt * BN, (int)P,
             (int)k_chunk};
  cudaStream_t s = (cudaStream_t)stream;
  conv3x3_wgrad_kernel<<<dim3(nt, mt, splits), THREADS, 0, s>>>(pr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = (long long)M * N;
  conv3x3_wgrad_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      (const float*)ws, (float*)dw, splits, ci, co, (long long)mt * BM, nt * BN);
  return (int)cudaGetLastError();
}

const char* wgrad_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
