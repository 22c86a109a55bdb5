// Train-mode batch norm for Hopper, three launches a direction: the
// per-channel sums, a finalize that turns them into per-channel
// coefficients, and one elementwise pass. bf16 activations, float32
// statistics and arithmetic.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_bn.py, which also holds their plain PyTorch
// versions and the autograd function that runs them).
//
// Layout: every activation is channels_last, so each kernel reads the
// (rows = N*H*W, C) matrix, rows contiguous. A thread owns 8 neighbouring
// channels (one 16-byte load a row), the C/8 threads of a row cover it in
// order, and a block of 256 threads holds 256 / (C/8) rows; a block walks
// rows with a stride of the whole grid, so each pass over the grid reads
// one contiguous stretch, and four rows are loaded before they are used,
// to keep enough loads in flight. A thread's channels are the same on
// every row, so the elementwise passes keep their per-channel
// coefficients in registers.
//
// bn_sums_kernel and bn_grad_sums_kernel (K8)
//   Replace the TPU kernels of primia_tpu/ops/pallas_bn.py: _sums_kernel and
//   _gsums_kernel (pallas_call in _run_reduce, the row-major view) and
//   _sums_kernel_bm and _gsums_kernel_bm (pallas_call in _run_reduce_bm, the
//   batch-minor view). Those are one function laid out two ways for the
//   TPU's 128 lanes; here both read the one channels_last matrix.
//   (sum x, sum x^2) and (sum g, sum g*x) in one read of their inputs. Each
//   block sums its threads in shared memory in a fixed order and writes
//   one (2, C) partial. The wrapper fits the block count to the rows (a
//   whole number of waves, each block at least a few unrolled passes), so a
//   small activation writes few partials.
//
// bn_finalize_kernel and bn_grad_finalize_kernel
//   One warp a channel sums the partials in a fixed order (lanes stride
//   over the blocks, then a fixed shuffle tree), so the result does not
//   depend on timing, and its first lane computes the channel's
//   coefficients with every product, quotient and sum rounded apart, as the
//   plain version's PyTorch ops round these (C,) vectors on the card
//   (held bit for bit there by chip_smoke.py's phase 10: dgamma's S2 -
//   mean S1 cancels, so a fused multiply-add shows). Forward (the forward of
//   primia_tpu/ops/pallas_bn.py:bn_train, _bn_fwd_impl): mean, the biased
//   var, r = rsqrt(var + eps), inv = gamma r, off = beta - mean inv, and in
//   place the running statistics' update (momentum m, the unbiased var).
//   Backward (_bn_bwd): dgamma = r (S2 - mean S1), dbeta = S1, and the
//   per-channel A, B, D of dx = A g + B x + D.
//
// bn_apply_kernel and bn_dx_kernel
//   y = fma(x, inv, off) and dx = fma(x, B, fma(g, A, D)) in float32: on
//   these activations (bf16, the channel vectors broadcast) PyTorch's
//   addcmul gives one fused multiply-add on the card, and dx's cancellation
//   shows where a kernel rounds the product apart. Rounded once to bf16: one
//   read of x (of g and x) and one write. The JAX package leaves these to
//   XLA, which fuses them with their neighbours.
//
// Bound: bytes. A BN moves 16 bytes an element over its six launches: the
// sums read x (2), apply reads x and writes y (4), the gradient sums read g
// and x (4), dx reads g and x and writes dx (6); the finalizes move a few
// kB. At the train step's stem (200 x 64 x 112 x 112) that is 321, 642, 642
// and 963 MB (0.096, 0.192, 0.192, 0.288 ms at 3.35 TB/s); at layer4
// (200 x 512 x 7 x 7) 10 to 30 MB, where each launch's latency is the
// larger part. PERF.md, section 6, gives the times on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// A thread's place in the (rows, C) matrix: its 8 channels' group, its
// first row, the rows a block holds, and the stride of the grid in rows.
struct RowWalk {
  int groups, rows_per_iter, cg;
  long long row0, stride;
  __device__ RowWalk(int C) {
    groups = C / 8;
    rows_per_iter = THREADS / groups;
    cg = threadIdx.x % groups;
    const int r0 = threadIdx.x / groups;
    row0 = r0 < rows_per_iter ? (long long)blockIdx.x * rows_per_iter + r0 : -1;
    stride = (long long)gridDim.x * rows_per_iter;
  }
};

// The block's 16 sums a thread (8 channels x 2) go through shared memory;
// the threads of row 0 add the rows in order and write the partial.
__device__ __forceinline__ void block_partial(const float s[8], const float q[8],
                                              float* partial, int C, const RowWalk& w) {
  __shared__ float red[THREADS][17];
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[t][i] = s[i];
    red[t][8 + i] = q[i];
  }
  __syncthreads();
  if (t < w.groups) {
    float a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = 0.0f;
    for (int r = 0; r < w.rows_per_iter; ++r) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] += red[r * w.groups + t][i];
    }
    float* out = partial + (long long)blockIdx.x * 2 * C + t * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = a[i];
      out[C + i] = a[8 + i];
    }
  }
}

__device__ __forceinline__ uint4 load_row(const bf16* t, long long r, long long rows, int C,
                                          int cg) {
  return r < rows ? __ldg(reinterpret_cast<const uint4*>(t + r * C + cg * 8))
                  : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(THREADS)
bn_sums_kernel(const bf16* __restrict__ x, float* __restrict__ partial, long long rows, int C) {
  const RowWalk w(C);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
  if (w.row0 >= 0) {
    for (long long row = w.row0; row < rows; row += UNROLL * w.stride) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = load_row(x, row + u * w.stride, rows, C, w.cg);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float f[8];
        unpack8(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += f[i];
          q[i] = fmaf(f[i], f[i], q[i]);
        }
      }
    }
  }
  block_partial(s, q, partial, C, w);
}

__global__ void __launch_bounds__(THREADS)
bn_grad_sums_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                    float* __restrict__ partial, long long rows, int C) {
  const RowWalk w(C);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
  if (w.row0 >= 0) {
    for (long long row = w.row0; row < rows; row += UNROLL * w.stride) {
      uint4 vg[UNROLL], vx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        vg[u] = load_row(g, row + u * w.stride, rows, C, w.cg);
        vx[u] = load_row(x, row + u * w.stride, rows, C, w.cg);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float fg[8], fx[8];
        unpack8(vg[u], fg);
        unpack8(vx[u], fx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += fg[i];
          q[i] = fmaf(fg[i], fx[i], q[i]);
        }
      }
    }
  }
  block_partial(s, q, partial, C, w);
}

// Channel c's two sums over the nblocks partials (nblocks, 2, C), in a
// fixed order; every lane of the warp returns them.
__device__ __forceinline__ float2 warp_sums(const float* __restrict__ partial, int nblocks,
                                            int C, int c) {
  const int lane = threadIdx.x % 32;
  float a = 0.0f, b = 0.0f;
  for (int k = lane; k < nblocks; k += 32) {
    a += partial[(long long)k * 2 * C + c];
    b += partial[(long long)k * 2 * C + C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  return make_float2(__shfl_sync(0xffffffffu, a, 0), __shfl_sync(0xffffffffu, b, 0));
}

// stats (7, C): s1, s2, mean, var, r, inv, off. running_mean/var may be
// null (no update); keep = 1 - m, m_var = m n / (n - 1).
__global__ void __launch_bounds__(THREADS)
bn_finalize_kernel(const float* __restrict__ partial, int nblocks, int C,
                   const float* __restrict__ gamma, const float* __restrict__ beta, float n,
                   float eps, float* __restrict__ running_mean, float* __restrict__ running_var,
                   float keep, float m, float m_var, float* __restrict__ stats) {
  const int c = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (c >= C) return;
  const float2 s = warp_sums(partial, nblocks, C, c);
  if (threadIdx.x % 32 != 0) return;
  const float mean = __fdiv_rn(s.x, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s.y, n), __fmul_rn(mean, mean)), 0.0f);
  const float r = rsqrtf(__fadd_rn(var, eps));
  const float inv = __fmul_rn(gamma[c], r);
  const float off = __fsub_rn(beta[c], __fmul_rn(mean, inv));
  float* o = stats + c;
  o[0] = s.x;
  o[C] = s.y;
  o[2 * C] = mean;
  o[3 * C] = var;
  o[4 * C] = r;
  o[5 * C] = inv;
  o[6 * C] = off;
  if (running_mean != nullptr) {
    running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean, m));
    running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(var, m_var));
  }
}

// coef (6, C): S1 (= dbeta), S2, dgamma, A, B, D.
__global__ void __launch_bounds__(THREADS)
bn_grad_finalize_kernel(const float* __restrict__ partial, int nblocks, int C,
                        const float* __restrict__ gamma, const float* __restrict__ mean,
                        const float* __restrict__ r, float n, float* __restrict__ coef) {
  const int c = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (c >= C) return;
  const float2 S = warp_sums(partial, nblocks, C, c);
  if (threadIdx.x % 32 != 0) return;
  const float mu = mean[c], rc = r[c];
  const float dgamma = __fmul_rn(__fsub_rn(S.y, __fmul_rn(mu, S.x)), rc);
  const float A = __fmul_rn(gamma[c], rc);
  const float rm = __fmul_rn(rc, __fdiv_rn(dgamma, n));
  const float B = -__fmul_rn(A, rm);
  const float D = -__fmul_rn(__fsub_rn(__fdiv_rn(S.x, n), __fmul_rn(rm, mu)), A);
  float* o = coef + c;
  o[0] = S.x;
  o[C] = S.y;
  o[2 * C] = dgamma;
  o[3 * C] = A;
  o[4 * C] = B;
  o[5 * C] = D;
}

__device__ __forceinline__ void load8(const float* __restrict__ v, int cg, float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(v) + 2 * cg);
  const float4 b = __ldg(reinterpret_cast<const float4*>(v) + 2 * cg + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// y = fma(x, inv, off), rounded once to bf16; inv and off are rows of stats.
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ inv,
                const float* __restrict__ off, bf16* __restrict__ y, long long rows, int C) {
  const RowWalk w(C);
  if (w.row0 < 0) return;
  float a[8], b[8];
  load8(inv, w.cg, a);
  load8(off, w.cg, b);
  for (long long row = w.row0; row < rows; row += UNROLL * w.stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_row(x, row + u * w.stride, rows, C, w.cg);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = row + u * w.stride;
      if (r >= rows) break;
      float f[8];
      unpack8(v[u], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __fmaf_rn(f[i], a[i], b[i]);
      *reinterpret_cast<uint4*>(y + r * C + w.cg * 8) = pack8(f);
    }
  }
}

// dx = fma(x, B, fma(g, A, D)), rounded once to bf16; A, B, D are rows of coef.
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ D, bf16* __restrict__ dx, long long rows, int C) {
  const RowWalk w(C);
  if (w.row0 < 0) return;
  float a[8], b[8], d[8];
  load8(A, w.cg, a);
  load8(B, w.cg, b);
  load8(D, w.cg, d);
  for (long long row = w.row0; row < rows; row += UNROLL * w.stride) {
    uint4 vg[UNROLL], vx[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      vg[u] = load_row(g, row + u * w.stride, rows, C, w.cg);
      vx[u] = load_row(x, row + u * w.stride, rows, C, w.cg);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = row + u * w.stride;
      if (r >= rows) break;
      float fg[8], fx[8];
      unpack8(vg[u], fg);
      unpack8(vx[u], fx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        fg[i] = __fmaf_rn(fx[i], b[i], __fmaf_rn(fg[i], a[i], d[i]));
      *reinterpret_cast<uint4*>(dx + r * C + w.cg * 8) = pack8(fg);
    }
  }
}

bool bad_shape(long long rows, int C, int nblocks) {
  return rows <= 0 || C <= 0 || C % 8 != 0 || C / 8 > THREADS || nblocks <= 0;
}

int finalize_blocks(int C) { return (C + THREADS / 32 - 1) / (THREADS / 32); }

}  // namespace

extern "C" {

// x: (rows, C) bf16, rows contiguous, 16-byte aligned, C a multiple of 8 and
// at most 2048; partial: (nblocks, 2, C) float32, each block's
// (sum x, sum x^2).
int bn_sums(const void* x, void* partial, long long rows, int C, int nblocks, void* stream) {
  if (bad_shape(rows, C, nblocks)) return (int)cudaErrorInvalidValue;
  bn_sums_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>((const bf16*)x,
                                                                (float*)partial, rows, C);
  return (int)cudaGetLastError();
}

// g, x: (rows, C) bf16 as above; partial: each block's (sum g, sum g*x).
int bn_grad_sums(const void* g, const void* x, void* partial, long long rows, int C,
                 int nblocks, void* stream) {
  if (bad_shape(rows, C, nblocks)) return (int)cudaErrorInvalidValue;
  bn_grad_sums_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)x, (float*)partial, rows, C);
  return (int)cudaGetLastError();
}

// partial: (nblocks, 2, C) from bn_sums; gamma, beta: (C,) float32; stats:
// (7, C) float32 out. running_mean, running_var: (C,) float32 updated in
// place, or both null.
int bn_finalize(const void* partial, int nblocks, int C, const void* gamma, const void* beta,
                float n, float eps, void* running_mean, void* running_var, float keep, float m,
                float m_var, void* stats, void* stream) {
  if (bad_shape(1, C, nblocks) || (running_mean == nullptr) != (running_var == nullptr))
    return (int)cudaErrorInvalidValue;
  bn_finalize_kernel<<<finalize_blocks(C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nblocks, C, (const float*)gamma, (const float*)beta, n, eps,
      (float*)running_mean, (float*)running_var, keep, m, m_var, (float*)stats);
  return (int)cudaGetLastError();
}

// partial: (nblocks, 2, C) from bn_grad_sums; gamma, mean, r: (C,) float32;
// coef: (6, C) float32 out.
int bn_grad_finalize(const void* partial, int nblocks, int C, const void* gamma,
                     const void* mean, const void* r, float n, void* coef, void* stream) {
  if (bad_shape(1, C, nblocks)) return (int)cudaErrorInvalidValue;
  bn_grad_finalize_kernel<<<finalize_blocks(C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, nblocks, C, (const float*)gamma, (const float*)mean,
      (const float*)r, n, (float*)coef);
  return (int)cudaGetLastError();
}

// x, y: (rows, C) bf16 as above; inv, off: (C,) float32, 16-byte aligned.
int bn_apply(const void* x, const void* inv, const void* off, void* y, long long rows, int C,
             int nblocks, void* stream) {
  if (bad_shape(rows, C, nblocks)) return (int)cudaErrorInvalidValue;
  bn_apply_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)inv, (const float*)off, (bf16*)y, rows, C);
  return (int)cudaGetLastError();
}

// g, x, dx: (rows, C) bf16 as above; A, B, D: (C,) float32, 16-byte aligned.
int bn_dx(const void* g, const void* x, const void* A, const void* B, const void* D, void* dx,
          long long rows, int C, int nblocks, void* stream) {
  if (bad_shape(rows, C, nblocks)) return (int)cudaErrorInvalidValue;
  bn_dx_kernel<<<nblocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)x, (const float*)A, (const float*)B, (const float*)D,
      (bf16*)dx, rows, C);
  return (int)cudaGetLastError();
}

const char* bn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
