// The per-channel sums of train-mode batch norm for Hopper: (sum x, sum x^2)
// for the forward statistics and (sum g, sum g*x) for the backward, each in
// one read of its inputs, bf16 in and float32 accumulation.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_bn.py, which also holds their plain PyTorch
// versions).
//
// bn_sums_kernel and bn_grad_sums_kernel (K8)
//   Replace the TPU kernels of primia_tpu/ops/pallas_bn.py: _sums_kernel and
//   _gsums_kernel (pallas_call in _run_reduce, the row-major view) and
//   _sums_kernel_bm and _gsums_kernel_bm (pallas_call in _run_reduce_bm, the
//   batch-minor view). Those are one function laid out two ways for the
//   TPU's 128 lanes; here the activations are channels_last, so both read
//   the same (rows = N*H*W, C) matrix, rows contiguous.
//
//   A thread owns 8 neighbouring channels (one 16-byte load a row), the
//   threads of a row cover it in order, and a block walks rows with a
//   stride of the whole grid, so each pass over the grid reads one
//   contiguous stretch. Four rows are loaded before they are summed, to
//   keep enough loads in flight. Each block sums its threads in shared
//   memory in a fixed order and writes one (2, C) partial; a second kernel,
//   bn_partials_reduce_kernel, sums the partials in block order with one
//   warp per output, so the result does not depend on timing.
//
//   Bound: bytes. At the train step's stem (200 x 64 x 112 x 112) the sums
//   read 321 MB (0.096 ms at 3.35 TB/s) and the gradient sums 642 MB
//   (0.192 ms); at layer4 (200 x 512 x 7 x 7) 10 MB and 20 MB, where the
//   two launches' latency is the larger part.

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

// The block's 16 sums a thread (8 channels x 2) go through shared memory;
// the threads of row 0 add the rows in order and write the partial.
__device__ __forceinline__ void block_partial(float s[8], float q[8], float* partial, int C,
                                              int groups, int rows_per_iter) {
  __shared__ float red[THREADS][17];
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[t][i] = s[i];
    red[t][8 + i] = q[i];
  }
  __syncthreads();
  if (t < groups) {
    float a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = 0.0f;
    for (int r = 0; r < rows_per_iter; ++r) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] += red[r * groups + t][i];
    }
    float* out = partial + (long long)blockIdx.x * 2 * C + t * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = a[i];
      out[C + i] = a[8 + i];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bn_sums_kernel(const bf16* __restrict__ x, float* __restrict__ partial, long long rows, int C) {
  const int groups = C / 8;
  const int rows_per_iter = THREADS / groups;
  const int cg = threadIdx.x % groups;
  const int r0 = threadIdx.x / groups;
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
  if (r0 < rows_per_iter) {
    const long long stride = (long long)gridDim.x * rows_per_iter;
    for (long long row = (long long)blockIdx.x * rows_per_iter + r0; row < rows;
         row += UNROLL * stride) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = row + u * stride;
        v[u] = r < rows ? *reinterpret_cast<const uint4*>(x + r * C + cg * 8)
                        : make_uint4(0, 0, 0, 0);
      }
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
  block_partial(s, q, partial, C, groups, rows_per_iter);
}

__global__ void __launch_bounds__(THREADS)
bn_grad_sums_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                    float* __restrict__ partial, long long rows, int C) {
  const int groups = C / 8;
  const int rows_per_iter = THREADS / groups;
  const int cg = threadIdx.x % groups;
  const int r0 = threadIdx.x / groups;
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
  if (r0 < rows_per_iter) {
    const long long stride = (long long)gridDim.x * rows_per_iter;
    for (long long row = (long long)blockIdx.x * rows_per_iter + r0; row < rows;
         row += UNROLL * stride) {
      uint4 vg[UNROLL], vx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = row + u * stride;
        const bool in = r < rows;
        vg[u] = in ? *reinterpret_cast<const uint4*>(g + r * C + cg * 8) : make_uint4(0, 0, 0, 0);
        vx[u] = in ? *reinterpret_cast<const uint4*>(x + r * C + cg * 8) : make_uint4(0, 0, 0, 0);
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
  block_partial(s, q, partial, C, groups, rows_per_iter);
}

// out[i] = sum over blocks b of partial[b][i], i < 2C: one warp an output,
// lanes striding over the blocks, then a fixed shuffle tree.
__global__ void __launch_bounds__(THREADS)
bn_partials_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                          int nblocks, int outs) {
  const int i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= outs) return;
  float a = 0.0f;
  for (int b = lane; b < nblocks; b += 32) a += partial[(long long)b * outs + i];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) a += __shfl_down_sync(0xffffffffu, a, off);
  if (lane == 0) out[i] = a;
}

int launch(bool grad, const void* g, const void* x, void* partial, void* out, long long rows,
           int C, int nblocks, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 != 0 || C / 8 > THREADS || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (grad)
    bn_grad_sums_kernel<<<nblocks, THREADS, 0, s>>>((const bf16*)g, (const bf16*)x,
                                                    (float*)partial, rows, C);
  else
    bn_sums_kernel<<<nblocks, THREADS, 0, s>>>((const bf16*)x, (float*)partial, rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = 2 * C;
  const int warps = THREADS / 32;
  bn_partials_reduce_kernel<<<(outs + warps - 1) / warps, THREADS, 0, s>>>(
      (const float*)partial, (float*)out, nblocks, outs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (rows, C) bf16, rows contiguous, 16-byte aligned, C a multiple of 8 and
// at most 2048; partial: (nblocks, 2, C) float32 scratch; out: (2, C)
// float32 = (sum x, sum x^2).
int bn_sums(const void* x, void* partial, void* out, long long rows, int C, int nblocks,
            void* stream) {
  return launch(false, nullptr, x, partial, out, rows, C, nblocks, stream);
}

// g, x: (rows, C) bf16 as above; out: (2, C) float32 = (sum g, sum g*x).
int bn_grad_sums(const void* g, const void* x, void* partial, void* out, long long rows, int C,
                 int nblocks, void* stream) {
  return launch(true, g, x, partial, out, rows, C, nblocks, stream);
}

const char* bn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
