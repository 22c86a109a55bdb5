// Swin's layer norms for Hopper: one forward and one backward launch a call,
// plus one small launch that sums the gamma and beta gradients' partials.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_swin_norm.py, which also holds their plain
// PyTorch version and the autograd function that runs them).
//
// What it replaces. No TPU kernel: the JAX package has no Swin. In
// nn/swin.py a block's residual stream went, between its GEMMs, through
// F.layer_norm (float32 in and out), torch.roll (shifted blocks), the window
// partition (a copy of a transposed view), autocast's cast to bf16 for qkv;
// then after proj the window reverse (a copy), a second roll and the
// residual add x + y; autograd ran each of them again backward. Rolls and
// window partitions move whole tokens, each token's C channels contiguous:
// a row permutation, which a layer norm that reads and writes every row
// anyway can apply on its write and undo on its read.
//
// The function. x is a (B, H, W, C) map of tokens, rows of C; an order
// (window, shift) is the map rolled by (-shift, -shift) and partitioned into
// window x window windows in row-major order, (B, nW, L, C), as torch.roll
// and window_partition give it; window 0 is the natural order. Forward:
//   s = x [+ branch, read at its order]  (rounded to bf16 where x and the
//                                         branch are bf16, as their add is)
//   y = (s - mean) * rstd * gamma + beta, written at the out order in the
//       out dtype; mean and rstd = 1 / sqrt(var + eps) kept for the backward.
// Backward, from dy (at the out order) and ds (the residual stream's own
// gradient, where there is one):
//   d = rstd (dy gamma - mean(dy gamma) - xh mean(dy gamma xh)) [+ ds],
//   xh = (s - mean) rstd, d rounded to the sum's dtype before and after the
//   add, as autograd's cast and accumulation round them; dx = d in x's
//   dtype, natural order; the branch's gradient = d in its dtype at its
//   order; dgamma = sum dy xh, dbeta = sum dy over the rows.
// All arithmetic in float32; bf16 only where autocast would round.
//
// Names. No kernel's name holds a token under which benchmark/trace.py
// files a kernel as a convolution, GEMM or a port kernel: their time counts
// as elementwise, where the operations they replace were counted.
//
// Bound: bytes. A few operations an element against 4-16 bytes moved: the
// forward reads x (and the branch) and writes y (and the sum), 6 bytes an
// element for norm1 (float32 in, bf16 out) and 12 for norm2 (float32 x,
// bf16 branch, float32 sum, bf16 y); the backward reads dy and the saved
// sum (and ds) and writes dx (and the branch's gradient): 14 and 16.
//
// Layout, and how it answers that:
// - A team of TPR threads owns a row, 4 channels a chunk, K chunks a thread
//   (chunk k TPR + lane): the row's loads and stores are 16-byte (float32)
//   or 8-byte (bf16) accesses of consecutive threads, and the row stays in
//   registers between the mean, the variance and the write. TPR and K follow
//   C (at most 16 channels a thread): C 128 takes a warp with one chunk a
//   lane, C 2048 four warps with four.
// - The mean, the variance and the backward's two row sums are butterfly
//   shuffles in a warp, then, for a team of several warps, one pass through
//   shared memory in a fixed order: every lane holds the same bits.
// - The permutation is index arithmetic on the row number (slot()), so no
//   index tensor is read; a whole row moves, so writes stay coalesced.
// - The backward walks a fixed set of rows per CTA (grid-stride, as many
//   CTAs as the card holds at once), each thread keeping its channels' dgamma
//   and dbeta in registers across them; the CTA sums its teams' in shared
//   memory in order and writes one partial, and swin_norm_finalize_kernel
//   sums the partials in a fixed order: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_C = 4096;  // 256 threads x 4 chunks x 4 channels
constexpr unsigned FULL = 0xffffffffu;

// bits of `dtypes`: which operands are bf16 (the rest float32)
enum { X_BF16 = 1, BRANCH_BF16 = 2, OUT_BF16 = 4 };

struct Order {
  int window, shift;  // window 0: the natural order
};

struct Args {
  const void* x;       // forward: x; backward: the saved sum (or x, no branch)
  const void* branch;  // forward: the branch or null; backward: ds or null
  void* sum;           // forward: the sum or null; backward: dx
  void* y;             // forward: y; backward: the branch's gradient or null
  const void* dy;      // backward: dy
  float2* stats;       // (rows,): mean, rstd
  const float* gamma;
  const float* beta;
  float* partial;      // backward: (nblk, 2C), each CTA's dgamma, dbeta
  long long rows;
  int H, W, C, dtypes;
  Order branch_order, out_order;
  float eps;
};

// the row of `row`'s token in `o`'s layout, in 32-bit unsigned arithmetic
// (the launchers take fewer than 2^31 rows): its divisions lie on the path
// to the row's first load
__device__ __forceinline__ long long slot(long long row, const Args& a, Order o) {
  if (o.window == 0) return row;
  const unsigned hw = a.H * a.W, n = static_cast<unsigned>(row), win = o.window;
  const unsigned b = n / hw, t = n - b * hw;
  const unsigned h = t / a.W, w = t - h * a.W;
  // rolled by (-shift, -shift)
  const unsigned r = h >= unsigned(o.shift) ? h - o.shift : h + a.H - o.shift;
  const unsigned c = w >= unsigned(o.shift) ? w - o.shift : w + a.W - o.shift;
  const unsigned wy = r / win, ly = r - wy * win;
  const unsigned wx = c / win, lx = c - wx * win;
  return static_cast<long long>((b * (a.H / win) + wy) * (a.W / win) + wx) * (win * win) +
         ly * win + lx;
}

__device__ __forceinline__ float4 load4(const void* base, long long i, bool is_bf16) {
  if (is_bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(base) + i);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
}

__device__ __forceinline__ void store4(void* base, long long i, float4 v, bool is_bf16) {
  if (is_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(base) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = v;
  }
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float hsum(float4 v) { return (v.x + v.y) + (v.z + v.w); }

// the sum of v over the team of TPR threads, the same bits in every thread:
// a butterfly in each warp, then the team's warps in order through `red`
template <int TPR>
__device__ __forceinline__ float2 team_sum(float2 v, float2* red) {
  for (int o = 16; o; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
  }
  if (TPR == 32) return v;
  constexpr int WARPS = TPR / 32;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp / WARPS * WARPS;
  float2 s = red[first];
  for (int i = 1; i < WARPS; ++i) {
    s.x += red[first + i].x;
    s.y += red[first + i].y;
  }
  __syncthreads();
  return s;
}

// ------------------------------------------------------------- forward

// one team a row; CTAs of THREADS / TPR rows
template <int K, int TPR>
__global__ void __launch_bounds__(THREADS) swin_norm_fwd_kernel(Args a) {
  constexpr int TEAMS = THREADS / TPR;
  __shared__ float2 red[THREADS / 32];
  const int team = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * TEAMS + team;
  const bool live = row < a.rows;  // the same for the whole team
  const int nc = a.C >> 2;
  const bool xb = a.dtypes & X_BF16, bb = a.dtypes & BRANCH_BF16, ob = a.dtypes & OUT_BF16;
  const bool sb = xb && (a.branch == nullptr || bb);  // the sum's dtype
  const long long nat = row * a.C;
  const long long at_branch = a.branch != nullptr && live ? slot(row, a, a.branch_order) * a.C : 0;
  float4 v[K];
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k * TPR + lane;
    v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live && j < nc) {
      v[k] = load4(a.x, nat + 4 * j, xb);
      if (a.branch != nullptr) {
        v[k] = v[k] + load4(a.branch, at_branch + 4 * j, bb);
        if (sb) v[k] = round_bf16(v[k]);
        store4(a.sum, nat + 4 * j, v[k], sb);
      }
      total += hsum(v[k]);
    }
  }
  const float inv_c = 1.0f / static_cast<float>(a.C);
  const float mean = team_sum<TPR>(make_float2(total, 0.0f), red).x * inv_c;
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * TPR + lane < nc) {
      const float4 d = make_float4(v[k].x - mean, v[k].y - mean, v[k].z - mean, v[k].w - mean);
      sq += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
    }
  }
  const float rstd = rsqrtf(team_sum<TPR>(make_float2(sq, 0.0f), red).x * inv_c + a.eps);
  if (!live) return;
  const long long at_out = slot(row, a, a.out_order) * a.C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = k * TPR + lane;
    if (j >= nc) continue;
    const float4 g = *reinterpret_cast<const float4*>(a.gamma + 4 * j);
    const float4 b = *reinterpret_cast<const float4*>(a.beta + 4 * j);
    const float4 o = make_float4((v[k].x - mean) * rstd * g.x + b.x,
                                 (v[k].y - mean) * rstd * g.y + b.y,
                                 (v[k].z - mean) * rstd * g.z + b.z,
                                 (v[k].w - mean) * rstd * g.w + b.w);
    store4(a.y, at_out + 4 * j, o, ob);
  }
  if (lane == 0) a.stats[row] = make_float2(mean, rstd);
}

// ------------------------------------------------------------ backward

// a.x: the saved sum (x where there was no branch); a.branch: ds or null;
// a.sum: dx; a.y: the branch's gradient or null (no branch); a.dy: dy
template <int K, int TPR>
__global__ void __launch_bounds__(THREADS) swin_norm_bwd_kernel(Args a) {
  constexpr int TEAMS = THREADS / TPR;
  constexpr int CW = 4 * K * TPR;  // a team's channels, at most
  __shared__ float2 red[THREADS / 32];
  __shared__ float part[2 * TEAMS * CW];
  const int team = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int nc = a.C >> 2;
  const bool has_branch = a.y != nullptr;
  const bool xb = a.dtypes & X_BF16, bb = a.dtypes & BRANCH_BF16, ob = a.dtypes & OUT_BF16;
  const bool sb = xb && (!has_branch || bb);
  const float inv_c = 1.0f / static_cast<float>(a.C);
  float4 dg[K], db[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dg[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    db[k] = dg[k];
  }
  // the trip count is the CTA's, so every team reaches each barrier
  for (long long first = static_cast<long long>(blockIdx.x) * TEAMS; first < a.rows;
       first += static_cast<long long>(gridDim.x) * TEAMS) {
    const long long row = first + team;
    const bool live = row < a.rows;
    const long long nat = row * a.C;
    float2 st = make_float2(0.0f, 0.0f);
    long long at_out = 0, at_branch = 0;
    if (live) {
      st = a.stats[row];
      at_out = slot(row, a, a.out_order) * a.C;
      if (has_branch) at_branch = slot(row, a, a.branch_order) * a.C;
    }
    // every load of the row first, ds's too, so the row waits on memory once
    float4 xh[K], g[K], ds[K];
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * TPR + lane;
      xh[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g[k] = xh[k];
      ds[k] = xh[k];
      if (live && j < nc) {
        if (a.branch != nullptr) ds[k] = load4(a.branch, nat + 4 * j, sb);
        const float4 s = load4(a.x, nat + 4 * j, sb);
        const float4 dy = load4(a.dy, at_out + 4 * j, ob);
        const float4 gm = *reinterpret_cast<const float4*>(a.gamma + 4 * j);
        xh[k] = make_float4((s.x - st.x) * st.y, (s.y - st.x) * st.y, (s.z - st.x) * st.y,
                            (s.w - st.x) * st.y);
        g[k] = make_float4(dy.x * gm.x, dy.y * gm.y, dy.z * gm.z, dy.w * gm.w);
        sg += hsum(g[k]);
        sgx += (g[k].x * xh[k].x + g[k].y * xh[k].y) + (g[k].z * xh[k].z + g[k].w * xh[k].w);
        dg[k] = make_float4(fmaf(dy.x, xh[k].x, dg[k].x), fmaf(dy.y, xh[k].y, dg[k].y),
                            fmaf(dy.z, xh[k].z, dg[k].z), fmaf(dy.w, xh[k].w, dg[k].w));
        db[k] = db[k] + dy;
      }
    }
    const float2 sums = team_sum<TPR>(make_float2(sg, sgx), red);
    if (!live) continue;
    const float mg = sums.x * inv_c, mgx = sums.y * inv_c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * TPR + lane;
      if (j >= nc) continue;
      float4 d = make_float4(st.y * (g[k].x - mg - xh[k].x * mgx),
                             st.y * (g[k].y - mg - xh[k].y * mgx),
                             st.y * (g[k].z - mg - xh[k].z * mgx),
                             st.y * (g[k].w - mg - xh[k].w * mgx));
      if (sb) d = round_bf16(d);
      if (a.branch != nullptr) {
        d = d + ds[k];
        if (sb) d = round_bf16(d);
      }
      store4(a.sum, nat + 4 * j, d, xb);
      if (has_branch) store4(a.y, at_branch + 4 * j, d, bb);
    }
  }
  // this CTA's dgamma and dbeta: its teams' in order
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = 4 * (k * TPR + lane);
    float* pg = part + team * CW + c;
    float* pb = part + (TEAMS + team) * CW + c;
    if (c < a.C) {
      pg[0] = dg[k].x, pg[1] = dg[k].y, pg[2] = dg[k].z, pg[3] = dg[k].w;
      pb[0] = db[k].x, pb[1] = db[k].y, pb[2] = db[k].z, pb[3] = db[k].w;
    }
  }
  __syncthreads();
  float* out = a.partial + static_cast<long long>(blockIdx.x) * 2 * a.C;
  for (int c = threadIdx.x; c < a.C; c += THREADS) {
    float sgm = part[c], sbt = part[TEAMS * CW + c];
    for (int t = 1; t < TEAMS; ++t) {
      sgm += part[t * CW + c];
      sbt += part[(TEAMS + t) * CW + c];
    }
    out[c] = sgm;
    out[a.C + c] = sbt;
  }
}

// out[c] = the sum over the nblk partials' column c, in order: a (32, 32)
// CTA takes 32 columns, each row of threads every 32nd partial
__global__ void __launch_bounds__(1024) swin_norm_finalize_kernel(const float* partial, int nblk,
                                                                  int n, float* out) {
  __shared__ float acc[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < n)
    for (int b = threadIdx.y; b < nblk; b += 32) s += partial[static_cast<long long>(b) * n + c];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= n) return;
  float t = acc[0][threadIdx.x];
  for (int i = 1; i < 32; ++i) t += acc[i][threadIdx.x];
  out[c] = t;
}

// ------------------------------------------------------------ launchers

// the build for C: (chunks a thread, threads a row), at most 4 chunks a
// thread, as few threads as that allows (a warp at least)
enum Build { K1_T32, K2_T32, K4_T32, K4_T64, K4_T128, K4_T256, NO_BUILD };

Build build_for(int C) {
  const int nc = C / 4;
  if (nc <= 32) return K1_T32;
  if (nc <= 64) return K2_T32;
  if (nc <= 128) return K4_T32;
  if (nc <= 256) return K4_T64;
  if (nc <= 512) return K4_T128;
  if (nc <= 1024) return K4_T256;
  return NO_BUILD;
}

int teams_of(Build b) {
  switch (b) {
    case K4_T64: return THREADS / 64;
    case K4_T128: return THREADS / 128;
    case K4_T256: return THREADS / 256;
    default: return THREADS / 32;
  }
}

template <bool BWD, int K, int TPR>
const void* kernel() {
  return BWD ? reinterpret_cast<const void*>(swin_norm_bwd_kernel<K, TPR>)
             : reinterpret_cast<const void*>(swin_norm_fwd_kernel<K, TPR>);
}

template <bool BWD>
const void* kernel_for(Build b) {
  switch (b) {
    case K1_T32: return kernel<BWD, 1, 32>();
    case K2_T32: return kernel<BWD, 2, 32>();
    case K4_T32: return kernel<BWD, 4, 32>();
    case K4_T64: return kernel<BWD, 4, 64>();
    case K4_T128: return kernel<BWD, 4, 128>();
    case K4_T256: return kernel<BWD, 4, 256>();
    default: return nullptr;
  }
}

bool bad_order(int H, int W, int window, int shift) {
  if (window == 0) return shift != 0;
  return window < 0 || H % window || W % window || shift < 0 || shift >= window;
}

bool bad_shape(long long rows, int H, int W, int C, int dtypes, int bw, int bs, int ow,
               int os) {
  return rows < 1 || rows > 0x7fffffffLL || H < 1 || W < 1 ||
         rows % (static_cast<long long>(H) * W) || C < 4 ||
         C % 4 || C > MAX_C || dtypes < 0 || dtypes > 7 || bad_order(H, W, bw, bs) ||
         bad_order(H, W, ow, os);
}

Args make_args(const void* x, const void* branch, void* sum, void* y, const void* dy,
               void* stats, const void* gamma, const void* beta, void* partial, long long rows,
               int H, int W, int C, int dtypes, int bw, int bs, int ow, int os, float eps) {
  Args a;
  a.x = x;
  a.branch = branch;
  a.sum = sum;
  a.y = y;
  a.dy = dy;
  a.stats = static_cast<float2*>(stats);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.partial = static_cast<float*>(partial);
  a.rows = rows;
  a.H = H;
  a.W = W;
  a.C = C;
  a.dtypes = dtypes;
  a.branch_order = {bw, bs};
  a.out_order = {ow, os};
  a.eps = eps;
  return a;
}

cudaError_t launch(const void* k, dim3 grid, dim3 block, Args a, cudaStream_t stream) {
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(k, grid, block, params, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward: y (rows of C at the out order (ow, os), bf16 where dtypes
// has OUT_BF16), the rows' (mean, rstd), and, where branch is not null
// (rows of C at the order (bw, bs)), the sum x + branch into `sum`. x, the
// branch and the sum contiguous, 16-byte aligned rows (8-byte in bf16).
int swin_norm_fwd(const void* x, const void* branch, void* sum, void* y, void* stats,
                  const void* gamma, const void* beta, long long rows, int H, int W, int C,
                  int dtypes, int bw, int bs, int ow, int os, float eps, void* stream) {
  if (bad_shape(rows, H, W, C, dtypes, bw, bs, ow, os) || (branch == nullptr) != (sum == nullptr))
    return (int)cudaErrorInvalidValue;
  const Build b = build_for(C);
  const long long grid = (rows + teams_of(b) - 1) / teams_of(b);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, branch, sum, y, nullptr, stats, gamma, beta, nullptr, rows, H, W,
                           C, dtypes, bw, bs, ow, os, eps);
  return (int)launch(kernel_for<false>(b), dim3((unsigned)grid), dim3(THREADS), a,
                     (cudaStream_t)stream);
}

// The backward: dx (natural order, x's dtype) from dy (at the out order),
// the saved sum (x where there was no branch), the stats and, where not
// null, ds (the sum's dtype); where dbranch is not null the branch's
// gradient at (bw, bs); then dgamma and dbeta, (2, C) float32 in dgb, from
// nblk CTAs' partials (partial: (nblk, 2C) float32).
int swin_norm_bwd(const void* dy, const void* ds, const void* saved, const void* stats,
                  const void* gamma, void* dx, void* dbranch, void* partial, void* dgb,
                  long long rows, int H, int W, int C, int dtypes, int bw, int bs, int ow, int os,
                  int nblk, void* stream) {
  if (bad_shape(rows, H, W, C, dtypes, bw, bs, ow, os) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(saved, ds, dx, dbranch, dy, const_cast<void*>(stats), gamma, nullptr,
                           partial, rows, H, W, C, dtypes, bw, bs, ow, os, 0.0f);
  const cudaError_t err = launch(kernel_for<true>(build_for(C)), dim3(nblk), dim3(THREADS), a,
                                 (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  swin_norm_finalize_kernel<<<(2 * C + 31) / 32, dim3(32, 32), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(partial), nblk, 2 * C, static_cast<float*>(dgb));
  return (int)cudaGetLastError();
}

// CTAs of the backward's build for C an SM holds at once; < 0: a CUDA
// error, negated.
int swin_norm_bwd_blocks_per_sm(int C) {
  if (C < 4 || C % 4 || C > MAX_C) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for<true>(build_for(C)), THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* swin_norm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
