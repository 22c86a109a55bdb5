// Swin's window attention for Hopper: one forward and one backward launch a
// call, plus one small launch that sums the bias gradient's partials.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_attention.py, which also holds their plain
// PyTorch version and the autograd function that runs them).
//
// What it replaces. No TPU kernel: the JAX package has no Swin. The port's
// nn/swin.py:window_attention called PyTorch's fused attention
// (F.scaled_dot_product_attention, its memory-efficient backend), which the
// port may not keep on its hot path, and which on this shape writes the
// bias gradient at the whole batch's size, (B nW, h, L, L), for a reduce to
// sum it again, and needs the bias plus the region mask built and cast
// every call and q, k, v and o copied into contiguous tensors.
//
// Names. Every kernel here keeps the token under which the benchmark finds
// the attention's kernels and PERF.md, section 3, groups them
// (benchmark/attention.py): the forward's name holds "fmha_cutlassF", the
// backward's and the finalize's "fmha_cutlassB". No kernel here is
// CUTLASS's.
//
// The work. A call has Bw = B nW windows of L <= 144 tokens, h heads of
// head dim 32. For each (window, head): S = q k^T / sqrt(32) + bias[head]
// (+ MASK_VALUE where the two tokens' region ids differ, in a shifted
// block), P = softmax(S) row by row, o = P v; backward dV = P^T dO, dS =
// P o (dP - rowsum(P o dP)) with dP = dO v^T, dQ = dS k / sqrt(32), dK =
// dS^T q / sqrt(32), and the bias gradient, the sum of dS over the windows.
//
// Bound: bytes. Forward and backward do 12 Bw h L^2 d FLOPs and move 12
// tensors of Bw h L d elements (q, k, v, o; q, k, v, dO, dq, dk, dv and the
// row log-sum-exp): at L = 144 and d = 32, 72 FLOPs a byte in bf16, a
// quarter of the 295 at which the H100's tensor cores, and not HBM, would
// be the limit.
//
// Layout, and how it answers that:
// - A CTA owns one head and walks a strided set of windows, so it reads
//   the head's (L, L) float32 bias once, into shared memory, in the order
//   of the mma accumulators (each thread reads back only what it wrote);
//   its padded columns hold -inf, which is the mask of the padding.
// - The whole window fits: L is padded to Lp, a multiple of 16, and warp w
//   owns query rows 16w..16w+15 of S with all Lp columns in registers (72
//   floats a thread at L = 144), so the softmax is exact over the row, in
//   float32, with no online rescaling; P = exp2 of the logits in base 2.
// - q, k, v and dO are read through their strides, straight from the qkv
//   linear's output and from proj's gradient: 64 bytes a token and head,
//   four 16-byte cp.async copies, into swizzled tiles (the 16-byte chunk c
//   of row r sits at c ^ ((r >> 1) & 3)) that ldmatrix reads without bank
//   conflicts. The next window's tiles load while this one computes (two
//   buffers).
// - Products on the tensor cores, mma.sync m16n8k16, bf16 in and float32
//   accumulated; P and dS feed the next product straight from the
//   accumulators' registers. The backward stages P, then dS, in shared
//   memory as bf16 (rows padded by 16 bytes) for the products whose rows
//   are keys (dV = P^T dO, dK = dS^T q), which warp w computes for keys
//   16w..16w+15. No atomics.
// - The bias gradient: each thread adds the float32 dS of its positions,
//   over every window its CTA walks, in registers; at the end the CTA
//   writes one (L, L) partial, and fmha_cutlassB_window_bias_grad_kernel
//   sums a head's partials in a fixed order. The same inputs give the same
//   bits.
// - Outputs: o, dq, dk, dv are written through their strides (the wrapper
//   gives (B, nW, L, h, d) buffers, so proj's input and the qkv gradient
//   are views of them); the row log-sum-exp, (Bw, h, L) float32 (in base 2
//   in the bf16 build, natural in the float32 one: each backward reads its
//   own forward's).
// - float32 inputs (Swin's eval and predict steps) take a float32 build of
//   the same work on the CUDA cores: no TF32, exact exp, the logits and P
//   in shared memory, one element a thread at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 32;           // the head dim
constexpr int MAX_L = 144;      // tokens a window: 12 x 12
constexpr float MASK_VALUE = -100.0f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int F32_THREADS = 256;
constexpr int F32_ROW = D + 1;  // float32 tiles' row stride, off the banks' period

// operands, by index into Args::in, Args::out and Args::st
enum { Q = 0, K = 1, V = 2, O = 3, DQ = 4, DK = 5, DV = 6, N_TENSORS = 7 };

struct Args {
  const void* in[4];    // q, k, v, and o (forward: written) or dO (backward: read)
  void* out[N_TENSORS]; // out[O] is o in the forward; out[DQ..DV] in the backward
  long long st[N_TENSORS][4];  // strides (b, w, h, l) in elements; d's is 1
  const float* bias;
  long long sb[3];      // the bias's strides (h, i, j)
  const int* regions;   // (nW, L) region ids, or null: unshifted
  float* lse;           // (Bw, h, L): log-sum-exp of each row's logits
  float* partial;       // (h, nblk, L, L): each CTA's sum of dS
  int nW, Bw, heads, L;
  float scale, scale2;  // 1 / sqrt(d), and times log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..3) of row r of a (rows, 32) bf16 tile
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 float32
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ long long window_base(const Args& a, int t, int wi, int head) {
  const int b = wi / a.nW, w = wi - b * a.nW;
  return b * a.st[t][0] + w * a.st[t][1] + head * a.st[t][2];
}

// ------------------------------------------------------------ bf16 path

template <int NT>
struct Shape {
  static constexpr int LP = 16 * NT;         // padded tokens
  static constexpr int NN = 2 * NT;          // 8-column tiles of a row of S
  static constexpr int THREADS = 32 * NT;    // a warp per 16 query rows
  static constexpr int TILE = LP * 64;       // bytes of a (LP, 32) bf16 tile
  static constexpr int BIAS = LP * LP * 4;   // bytes of the bias, float32
  static constexpr int SROW = 2 * LP + 16;   // bytes a row of the P / dS stage
};

// The head's bias times log2(e), in shared memory in the order of the S
// accumulators: entry ((warp NN + n) 2 + r) 32 + lane holds the pair of
// columns 8n + 2 (lane % 4) of row 16 warp + lane / 4 + 8 r; -inf in the
// padded columns.
template <int NT>
__device__ __forceinline__ void load_bias(const Args& a, int head, float2* bias_s) {
  using S = Shape<NT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bp = a.bias + head * a.sb[0];
#pragma unroll
  for (int n = 0; n < S::NN; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + (lane >> 2) + 8 * r, col = 8 * n + 2 * (lane & 3);
      float2 v;
      v.x = col < a.L ? (row < a.L ? bp[row * a.sb[1] + col * a.sb[2]] * LOG2E : 0.0f)
                      : -INFINITY;
      v.y = col + 1 < a.L
                ? (row < a.L ? bp[row * a.sb[1] + (col + 1) * a.sb[2]] * LOG2E : 0.0f)
                : -INFINITY;
      bias_s[((warp * S::NN + n) * 2 + r) * 32 + lane] = v;
    }
  }
}

// cp.async of window wi's NTILE tiles (q, k, v[, dO]) and region ids into
// buffer buf; rows past L are zero
template <int NT, int NTILE>
__device__ __forceinline__ void load_window(const Args& a, int head, int wi,
                                            unsigned char* tiles, int* ids_s, int buf) {
  using S = Shape<NT>;
#pragma unroll
  for (int x = 0; x < NTILE; ++x) {
    const bf16* base = static_cast<const bf16*>(a.in[x]) + window_base(a, x, wi, head);
    const uint32_t dst = smem_u32(tiles + (buf * NTILE + x) * S::TILE);
    for (int t = threadIdx.x; t < S::LP * 4; t += S::THREADS) {
      const int row = t >> 2, c = t & 3;
      const bool valid = row < a.L;
      cp_async16(dst + tile_off(row, c), base + (valid ? row : 0) * a.st[x][3] + 8 * c, valid);
    }
  }
  if (a.regions != nullptr) {
    const int w = wi % a.nW;
    for (int t = threadIdx.x; t < S::LP; t += S::THREADS)
      cp_async4(smem_u32(ids_s + buf * S::LP + t), a.regions + w * a.L + (t < a.L ? t : 0),
                t < a.L);
  }
}

// s = the warp's 16 rows of the logits in base 2: q k^T scale2 + bias (+
// the mask)
template <int NT>
__device__ __forceinline__ void logits(const Args& a, uint32_t qs, uint32_t ks,
                                       const float2* bias_s, const int* ids,
                                       float (&s)[2 * NT][4]) {
  using S = Shape<NT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) ldsm_x4(qa[kk], qs + tile_off(16 * warp + (lane & 15),
                                                              2 * kk + (lane >> 4)));
#pragma unroll
  for (int n = 0; n < S::NN; ++n) {
    uint32_t kb[4];
    ldsm_x4(kb, ks + tile_off(8 * n + (lane & 7), lane >> 3));
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    mma(s[n], qa[0], kb[0], kb[1]);
    mma(s[n], qa[1], kb[2], kb[3]);
  }
  int rid[2] = {0, 0};
  if (ids != nullptr) {
    rid[0] = ids[16 * warp + (lane >> 2)];
    rid[1] = ids[16 * warp + (lane >> 2) + 8];
  }
#pragma unroll
  for (int n = 0; n < S::NN; ++n) {
    float m[2] = {0.0f, 0.0f};
    int cid[2] = {0, 0};
    if (ids != nullptr) {
      cid[0] = ids[8 * n + 2 * (lane & 3)];
      cid[1] = ids[8 * n + 2 * (lane & 3) + 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 b = bias_s[((warp * S::NN + n) * 2 + r) * 32 + lane];
      if (ids != nullptr) {
        m[0] = cid[0] != rid[r] ? MASK_VALUE * LOG2E : 0.0f;
        m[1] = cid[1] != rid[r] ? MASK_VALUE * LOG2E : 0.0f;
      }
      s[n][2 * r] = fmaf(s[n][2 * r], a.scale2, b.x + m[0]);
      s[n][2 * r + 1] = fmaf(s[n][2 * r + 1], a.scale2, b.y + m[1]);
    }
  }
}

// a 16x8 float32 tile (rows row0, row0 + 8; columns col0 + 2 (lane % 4))
// times mul, as bf16 pairs into a (.., 32) tensor of row stride sl
__device__ __forceinline__ void store_rows(bf16* base, long long sl, int L, int row0,
                                           const float (&acc)[4][4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= L) continue;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<uint32_t*>(base + row * sl + 8 * nt + 2 * (lane & 3)) =
          pack(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * NT, 1) fmha_cutlassF_window_kernel(const Args a) {
  using S = Shape<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* bias_s = reinterpret_cast<float2*>(smem);
  unsigned char* tiles = smem + S::BIAS;
  int* ids_s = reinterpret_cast<int*>(tiles + 2 * 3 * S::TILE);
  const int head = blockIdx.y, nblk = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int wi = blockIdx.x;
  if (wi < a.Bw) load_window<NT, 3>(a, head, wi, tiles, ids_s, 0);
  cp_async_commit();
  load_bias<NT>(a, head, bias_s);
  for (int it = 0; wi < a.Bw; ++it, wi += nblk) {
    const int buf = it & 1;
    if (wi + nblk < a.Bw) load_window<NT, 3>(a, head, wi + nblk, tiles, ids_s, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const uint32_t qs = smem_u32(tiles + buf * 3 * S::TILE);
    float s[S::NN][4];
    logits<NT>(a, qs, qs + S::TILE, bias_s, a.regions ? ids_s + buf * S::LP : nullptr, s);
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < S::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int n = 0; n < S::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - mx[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    // o = P v, P from the accumulators: k-slice kk is column tiles 2kk, 2kk + 1
    float o[4][4] = {};
    const uint32_t vs = qs + 2 * S::TILE;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + tile_off(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                    2 * dn + (lane >> 4)));
        mma(o[2 * dn], pa, vb[0], vb[1]);
        mma(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    store_rows(static_cast<bf16*>(a.out[O]) + window_base(a, O, wi, head), a.st[O][3], a.L,
               16 * warp, o, 1.0f / l[0], 1.0f / l[1]);
    if ((lane & 3) == 0) {
      float* lse = a.lse + (static_cast<long long>(wi) * a.heads + head) * a.L;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + (lane >> 2) + 8 * r;
        if (row < a.L) lse[row] = mx[r] + __log2f(l[r]);
      }
    }
    __syncthreads();
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * NT, 1) fmha_cutlassB_window_kernel(const Args a) {
  using S = Shape<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* bias_s = reinterpret_cast<float2*>(smem);
  unsigned char* tiles = smem + S::BIAS;
  unsigned char* stage = tiles + 2 * 4 * S::TILE;
  int* ids_s = reinterpret_cast<int*>(stage + S::LP * S::SROW);
  const int head = blockIdx.y, nblk = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t stage_s = smem_u32(stage);
  load_bias<NT>(a, head, bias_s);
  float db[S::NN][4];
#pragma unroll
  for (int n = 0; n < S::NN; ++n) db[n][0] = db[n][1] = db[n][2] = db[n][3] = 0.0f;
  // the stage's address of this lane's piece of an ldmatrix.trans of P^T or
  // dS^T for keys 16 warp.. and queries 16 kq..
  const uint32_t stage_t =
      stage_s + ((lane & 7) + 8 * (lane >> 4)) * S::SROW + (16 * warp + 8 * ((lane >> 3) & 1)) * 2;
  int wi = blockIdx.x;
  if (wi < a.Bw) load_window<NT, 4>(a, head, wi, tiles, ids_s, 0);
  cp_async_commit();
  for (int it = 0; wi < a.Bw; ++it, wi += nblk) {
    const int buf = it & 1;
    if (wi + nblk < a.Bw) load_window<NT, 4>(a, head, wi + nblk, tiles, ids_s, buf ^ 1);
    cp_async_commit();
    float lr[2];
    {
      const float* lse = a.lse + (static_cast<long long>(wi) * a.heads + head) * a.L;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + (lane >> 2) + 8 * r;
        lr[r] = row < a.L ? lse[row] : INFINITY;  // padded rows: P = 0
      }
    }
    cp_async_wait1();
    __syncthreads();
    const uint32_t qs = smem_u32(tiles + buf * 4 * S::TILE), ks = qs + S::TILE,
                   vs = qs + 2 * S::TILE, dos = qs + 3 * S::TILE;
    float p[S::NN][4];
    logits<NT>(a, qs, ks, bias_s, a.regions ? ids_s + buf * S::LP : nullptr, p);
#pragma unroll
    for (int n = 0; n < S::NN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = exp2_approx(p[n][e] - lr[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(stage + (16 * warp + (lane >> 2) + 8 * r) * S::SROW +
                                     (8 * n + 2 * (lane & 3)) * 2) =
            pack(p[n][2 * r], p[n][2 * r + 1]);
    }
    __syncthreads();
    // dV = P^T dO for keys 16 warp..
    {
      float acc[4][4] = {};
#pragma unroll
      for (int kq = 0; kq < NT; ++kq) {
        uint32_t pa[4];
        ldsm_x4_t(pa, stage_t + 16 * kq * S::SROW);
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {
          uint32_t bb[4];
          ldsm_x4_t(bb, dos + tile_off(16 * kq + (lane & 7) + 8 * ((lane >> 3) & 1),
                                       2 * dn + (lane >> 4)));
          mma(acc[2 * dn], pa, bb[0], bb[1]);
          mma(acc[2 * dn + 1], pa, bb[2], bb[3]);
        }
      }
      store_rows(static_cast<bf16*>(a.out[DV]) + window_base(a, DV, wi, head), a.st[DV][3],
                 a.L, 16 * warp, acc, 1.0f, 1.0f);
    }
    // dP = dO v^T, twice: first for the rows' sums of P o dP, then for dS
    uint32_t da[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4(da[kk], dos + tile_off(16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < S::NN; ++n) {
      uint32_t vb[4];
      ldsm_x4(vb, vs + tile_off(8 * n + (lane & 7), lane >> 3));
      float dp[4] = {};
      mma(dp, da[0], vb[0], vb[1]);
      mma(dp, da[1], vb[2], vb[3]);
      rs[0] = fmaf(p[n][0], dp[0], fmaf(p[n][1], dp[1], rs[0]));
      rs[1] = fmaf(p[n][2], dp[2], fmaf(p[n][3], dp[3], rs[1]));
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    __syncthreads();  // every warp has read P from the stage
    float dq[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t sa[4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int n = 2 * kk + h2;
        uint32_t vb[4];
        ldsm_x4(vb, vs + tile_off(8 * n + (lane & 7), lane >> 3));
        float dp[4] = {};
        mma(dp, da[0], vb[0], vb[1]);
        mma(dp, da[1], vb[2], vb[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[e] = p[n][e] * (dp[e] - rs[e >> 1]);
          db[n][e] += dp[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sa[2 * h2 + r] = pack(dp[2 * r], dp[2 * r + 1]);
          *reinterpret_cast<uint32_t*>(stage + (16 * warp + (lane >> 2) + 8 * r) * S::SROW +
                                       (8 * n + 2 * (lane & 3)) * 2) = sa[2 * h2 + r];
        }
      }
      // dQ += dS[:, 16kk..] k[16kk.., :]
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        uint32_t kb[4];
        ldsm_x4_t(kb, ks + tile_off(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                    2 * dn + (lane >> 4)));
        mma(dq[2 * dn], sa, kb[0], kb[1]);
        mma(dq[2 * dn + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();
    // dK = dS^T q for keys 16 warp..
    {
      float acc[4][4] = {};
#pragma unroll
      for (int kq = 0; kq < NT; ++kq) {
        uint32_t sa[4];
        ldsm_x4_t(sa, stage_t + 16 * kq * S::SROW);
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {
          uint32_t qb[4];
          ldsm_x4_t(qb, qs + tile_off(16 * kq + (lane & 7) + 8 * ((lane >> 3) & 1),
                                      2 * dn + (lane >> 4)));
          mma(acc[2 * dn], sa, qb[0], qb[1]);
          mma(acc[2 * dn + 1], sa, qb[2], qb[3]);
        }
      }
      store_rows(static_cast<bf16*>(a.out[DK]) + window_base(a, DK, wi, head), a.st[DK][3],
                 a.L, 16 * warp, acc, a.scale, a.scale);
    }
    store_rows(static_cast<bf16*>(a.out[DQ]) + window_base(a, DQ, wi, head), a.st[DQ][3], a.L,
               16 * warp, dq, a.scale, a.scale);
    __syncthreads();
  }
  // this CTA's partial of the bias gradient
  float* part = a.partial + (static_cast<long long>(head) * nblk + blockIdx.x) * a.L * a.L;
#pragma unroll
  for (int n = 0; n < S::NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int col = 8 * n + 2 * (lane & 3) + (e & 1);
      if (row < a.L && col < a.L) part[row * a.L + col] = db[n][e];
    }
}

// ------------------------------------------------------------ float32 path

// window wi's NTILE tiles (q, k, v[, dO]) as (L, 33) float32 rows, and its
// region ids
template <int NTILE>
__device__ __forceinline__ void load_window_f32(const Args& a, int head, int wi, float* tiles,
                                                int* ids_s) {
  const int L = a.L;
#pragma unroll
  for (int x = 0; x < NTILE; ++x) {
    const float* base = static_cast<const float*>(a.in[x]) + window_base(a, x, wi, head);
    for (int t = threadIdx.x; t < L * D; t += blockDim.x) {
      const int row = t / D, c = t - row * D;
      tiles[(x * L + row) * F32_ROW + c] = base[row * a.st[x][3] + c];
    }
  }
  if (a.regions != nullptr)
    for (int t = threadIdx.x; t < L; t += blockDim.x) ids_s[t] = a.regions[(wi % a.nW) * L + t];
}

// the natural logit of (i, j): q_i . k_j scale + bias + the mask
__device__ __forceinline__ float logit_f32(const Args& a, const float* qs, const float* ks,
                                           const int* ids, const float* bp, int i, int j) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc = fmaf(qs[i * F32_ROW + c], ks[j * F32_ROW + c], acc);
  float x = acc * a.scale + bp[i * a.sb[1] + j * a.sb[2]];
  if (ids != nullptr && ids[i] != ids[j]) x += MASK_VALUE;
  return x;
}

__device__ __forceinline__ float dot_f32(const float* x, const float* y) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

__global__ void __launch_bounds__(F32_THREADS) fmha_cutlassF_window_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int L = a.L, head = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = fsm;
  float* ks = qs + L * F32_ROW;
  float* vs = ks + L * F32_ROW;
  float* ps = vs + L * F32_ROW;  // (L, L + 1)
  int* ids_s = reinterpret_cast<int*>(ps + L * (L + 1));
  const int* ids = a.regions ? ids_s : nullptr;
  const float* bp = a.bias + head * a.sb[0];
  for (int wi = blockIdx.x; wi < a.Bw; wi += gridDim.x) {
    load_window_f32<3>(a, head, wi, qs, ids_s);
    __syncthreads();
    for (int e = threadIdx.x; e < L * L; e += F32_THREADS) {
      const int i = e / L, j = e - i * L;
      ps[i * (L + 1) + j] = logit_f32(a, qs, ks, ids, bp, i, j);
    }
    __syncthreads();
    float* lse = a.lse + (static_cast<long long>(wi) * a.heads + head) * L;
    for (int i = warp; i < L; i += F32_THREADS / 32) {
      float* row = ps + i * (L + 1);
      float m = -INFINITY, sum = 0.0f;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      for (int j = lane; j < L; j += 32) sum += expf(row[j] - m);
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < L; j += 32) row[j] = expf(row[j] - m) / sum;
      if (lane == 0) lse[i] = m + logf(sum);
    }
    __syncthreads();
    float* op = static_cast<float*>(a.out[O]) + window_base(a, O, wi, head);
    for (int e = threadIdx.x; e < L * D; e += F32_THREADS) {
      const int i = e / D, c = e - i * D;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(ps[i * (L + 1) + j], vs[j * F32_ROW + c], acc);
      op[i * a.st[O][3] + c] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(F32_THREADS) fmha_cutlassB_window_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int L = a.L, head = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = fsm;
  float* ks = qs + L * F32_ROW;
  float* vs = ks + L * F32_ROW;
  float* dos = vs + L * F32_ROW;
  float* ps = dos + L * F32_ROW;  // (L, L + 1): P, then dS
  float* rs = ps + L * (L + 1);   // rowsum(P o dP)
  int* ids_s = reinterpret_cast<int*>(rs + L);
  const int* ids = a.regions ? ids_s : nullptr;
  const float* bp = a.bias + head * a.sb[0];
  // a thread owns the same elements of the (L, L) partial in every window
  float* part = a.partial + (static_cast<long long>(head) * gridDim.x + blockIdx.x) * L * L;
  for (int e = threadIdx.x; e < L * L; e += F32_THREADS) part[e] = 0.0f;
  for (int wi = blockIdx.x; wi < a.Bw; wi += gridDim.x) {
    load_window_f32<4>(a, head, wi, qs, ids_s);
    __syncthreads();
    const float* lse = a.lse + (static_cast<long long>(wi) * a.heads + head) * L;
    for (int e = threadIdx.x; e < L * L; e += F32_THREADS) {
      const int i = e / L, j = e - i * L;
      ps[i * (L + 1) + j] = expf(logit_f32(a, qs, ks, ids, bp, i, j) - lse[i]);
    }
    __syncthreads();
    float* dvp = static_cast<float*>(a.out[DV]) + window_base(a, DV, wi, head);
    for (int e = threadIdx.x; e < L * D; e += F32_THREADS) {
      const int j = e / D, c = e - j * D;
      float acc = 0.0f;
      for (int i = 0; i < L; ++i) acc = fmaf(ps[i * (L + 1) + j], dos[i * F32_ROW + c], acc);
      dvp[j * a.st[DV][3] + c] = acc;
    }
    for (int i = warp; i < L; i += F32_THREADS / 32) {
      float acc = 0.0f;
      for (int j = lane; j < L; j += 32)
        acc = fmaf(ps[i * (L + 1) + j], dot_f32(dos + i * F32_ROW, vs + j * F32_ROW), acc);
      for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) rs[i] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L * L; e += F32_THREADS) {
      const int i = e / L, j = e - i * L;
      float& pij = ps[i * (L + 1) + j];
      pij *= dot_f32(dos + i * F32_ROW, vs + j * F32_ROW) - rs[i];
      part[e] += pij;
    }
    __syncthreads();
    float* dqp = static_cast<float*>(a.out[DQ]) + window_base(a, DQ, wi, head);
    float* dkp = static_cast<float*>(a.out[DK]) + window_base(a, DK, wi, head);
    for (int e = threadIdx.x; e < L * D; e += F32_THREADS) {
      const int i = e / D, c = e - i * D;
      float aq = 0.0f, ak = 0.0f;
      for (int j = 0; j < L; ++j) {
        aq = fmaf(ps[i * (L + 1) + j], ks[j * F32_ROW + c], aq);
        ak = fmaf(ps[j * (L + 1) + i], qs[j * F32_ROW + c], ak);
      }
      dqp[i * a.st[DQ][3] + c] = aq * a.scale;
      dkp[i * a.st[DK][3] + c] = ak * a.scale;
    }
    __syncthreads();
  }
}

// dbias[h, i] = sum over the head's nblk partials, in order
__global__ void fmha_cutlassB_window_bias_grad_kernel(const float* partial, int nblk, int LL,
                                                      int total, float* dbias) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int hh = e / LL, i = e - hh * LL;
  const float* p = partial + static_cast<long long>(hh) * nblk * LL + i;
  float acc = 0.0f;
  for (int c = 0; c < nblk; ++c) acc += p[static_cast<long long>(c) * LL];
  dbias[e] = acc;
}

// ------------------------------------------------------------ launchers

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bf16(bool backward, dim3 grid, const Args& a, cudaStream_t stream) {
  using S = Shape<NT>;
  if (!backward)
    return launch(fmha_cutlassF_window_kernel<NT>, grid, S::THREADS,
                  S::BIAS + 2 * 3 * S::TILE + 2 * S::LP * 4, a, stream);
  return launch(fmha_cutlassB_window_kernel<NT>, grid, S::THREADS,
                S::BIAS + 2 * 4 * S::TILE + S::LP * S::SROW + 2 * S::LP * 4, a, stream);
}

cudaError_t launch_main(bool backward, int f32, dim3 grid, const Args& a, cudaStream_t stream) {
  if (f32) {
    const int L = a.L, tiles = (backward ? 4 : 3) * L * F32_ROW;
    const int smem = 4 * (tiles + L * (L + 1) + (backward ? L : 0) + L);
    return backward ? launch(fmha_cutlassB_window_f32_kernel, grid, F32_THREADS, smem, a, stream)
                    : launch(fmha_cutlassF_window_f32_kernel, grid, F32_THREADS, smem, a, stream);
  }
  switch ((a.L + 15) / 16) {
    case 1: return launch_bf16<1>(backward, grid, a, stream);
    case 2: return launch_bf16<2>(backward, grid, a, stream);
    case 3: return launch_bf16<3>(backward, grid, a, stream);
    case 4: return launch_bf16<4>(backward, grid, a, stream);
    case 5: return launch_bf16<5>(backward, grid, a, stream);
    case 6: return launch_bf16<6>(backward, grid, a, stream);
    case 7: return launch_bf16<7>(backward, grid, a, stream);
    case 8: return launch_bf16<8>(backward, grid, a, stream);
    case 9: return launch_bf16<9>(backward, grid, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ptrs: q, k, v, o or dO, dq, dk, dv, bias, regions (or 0), lse, partial,
// dbias (unused entries 0); strides: (b, w, h, l) of the first seven, then
// the bias's (h, i, j)
Args make_args(const long long* ptrs, const long long* strides, int B, int nW, int heads, int L,
               float scale) {
  Args a;
  for (int t = 0; t < 4; ++t) a.in[t] = reinterpret_cast<const void*>(ptrs[t]);
  for (int t = 0; t < N_TENSORS; ++t) {
    a.out[t] = reinterpret_cast<void*>(ptrs[t]);
    for (int s = 0; s < 4; ++s) a.st[t][s] = strides[4 * t + s];
  }
  a.bias = reinterpret_cast<const float*>(ptrs[7]);
  for (int s = 0; s < 3; ++s) a.sb[s] = strides[4 * N_TENSORS + s];
  a.regions = reinterpret_cast<const int*>(ptrs[8]);
  a.lse = reinterpret_cast<float*>(ptrs[9]);
  a.partial = reinterpret_cast<float*>(ptrs[10]);
  a.nW = nW;
  a.Bw = B * nW;
  a.heads = heads;
  a.L = L;
  a.scale = scale;
  a.scale2 = scale * LOG2E;
  return a;
}

bool bad_shape(int B, int nW, int heads, int L, int nblk) {
  return B < 1 || nW < 1 || heads < 1 || heads > 65535 || L < 1 || L > MAX_L || nblk < 1 ||
         nblk > B * nW;
}

}  // namespace

extern "C" {

// The forward: o (through its strides) and the row log-sum-exp. f32 picks
// the float32 build; otherwise q, k, v and o are bf16.
int window_attention_fwd(const long long* ptrs, const long long* strides, int B, int nW,
                         int heads, int L, float scale, int f32, int nblk, void* stream) {
  if (bad_shape(B, nW, heads, L, nblk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(ptrs, strides, B, nW, heads, L, scale);
  return (int)launch_main(false, f32, dim3(nblk, heads), a, (cudaStream_t)stream);
}

// The backward: dq, dk, dv (through their strides), then the bias gradient,
// (h, L, L) float32, from nblk partials a head.
int window_attention_bwd(const long long* ptrs, const long long* strides, int B, int nW,
                         int heads, int L, float scale, int f32, int nblk, void* stream) {
  if (bad_shape(B, nW, heads, L, nblk)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(ptrs, strides, B, nW, heads, L, scale);
  cudaError_t err = launch_main(true, f32, dim3(nblk, heads), a, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int total = heads * L * L;
  fmha_cutlassB_window_bias_grad_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      a.partial, nblk, L * L, total, reinterpret_cast<float*>(ptrs[11]));
  return (int)cudaGetLastError();
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
