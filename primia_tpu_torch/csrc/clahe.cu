// CLAHE (contrast-limited adaptive histogram equalisation) for Hopper.
//
// One kernel, clahe_kernel, bound to Python through the plain C launcher at
// the end (loaded with ctypes by primia_tpu_torch/ops/_build.py and wrapped
// in primia_tpu_torch/ops/cuda_clahe.py, which also holds its plain PyTorch
// version):
//
//   (N, H, W) uint8 planes -> (N, H, W) float32 in [0, 1]
//
// It replaces both TPU kernels of primia_tpu/ops/pallas_clahe.py and the
// division after them, the whole of _clahe_pallas_impl: _lut_kernel (the
// per-tile clipped-histogram LUTs, pallas_call in _lut_stage), _apply_kernel
// (the bilinear mix of four tiles' LUTs, the second pallas_call) and the
// final `/ 255.0`.
//
// Tile geometry: T tiles a side, each th = ceil(H/T) by tw = ceil(W/T)
// pixels; rows and columns past the image edge read the edge pixel, which
// is the reference's "edge" padding.
//
// Design: one thread-block cluster of T CTAs a plane (T <= 8, the portable
// cluster size); CTA r of the cluster owns tile row r.
//  1. Load. The CTA copies its band of rows [r*th, (r+1)*th), edge-clamped
//     to T*tw columns, into shared memory once (16-byte loads where the
//     rows allow), and computes each column's left tile and weight and each
//     band row's weight and upper tile row once.
//  2. Histograms. A thread takes 4 pixels of a band row at a time, with
//     their tiles from a per-column table. Chest X-rays have large flat
//     regions, so one bin can take most of a tile: 4 equal pixels of one
//     tile add 4 with one shared-memory atomic, and a warp's 128 pixels
//     span several tiles, so a flat region's atomics spread over several
//     addresses instead of piling onto one.
//  3. LUTs. Warp k makes tile k's LUT, lane l holding bins 8l .. 8l+7:
//     clip at `limit`, sum the excess (the lane's eight, then a warp
//     butterfly), spread it evenly (h = min(h, limit) + excess/256), an
//     inclusive scan (the lane's eight, then the lanes' totals),
//     lut = clip(rint(cdf / P * 255), 0, 255). With clip_limit 1 every value
//     is a multiple of 2^-12 below 2^10 at 224 px (28x28 tiles), and an
//     integer at 60 or 64 px (8x8 tiles, limit 1), so the f32 sums are
//     exact in any order and the LUTs equal the plain version's bit for
//     bit. The T LUTs go to shared memory as uint8 (exact: integers in
//     [0, 255]); only when the caller asks (the checks do) are they also
//     written out as f32.
//  4. Exchange. A band's rows mix tile rows r-1, r and r+1 only
//     (fy = (y - th/2)/th lies in [r - 1/2, r + 1/2)), so each CTA keeps a
//     table of packed corners, as the TPU kernel does: for a row whose
//     upper tile row is r-1 (h = 0) or r (h = 1) and a column whose left
//     tile is tx, the four corner LUT values of bin v in the four bytes of
//     pk[h][tx][v]. A corner pair of one tile row (its LUT at tx and at
//     min(tx+1, T-1)) fills two bytes, and its owner writes it, from
//     registers, into its own table and over distributed shared memory
//     into its neighbours' (r-1 reads row r as its lower row, r+1 as its
//     upper). A cluster barrier at the start (arrived at once, waited on
//     before the first remote store) makes sure every CTA of the cluster
//     runs; one more after the stores makes them visible. After it no CTA
//     touches another's shared memory, so any may exit. The LUTs never
//     touch device memory.
//  5. Apply. Each output pixel of the band reads its four corners with one
//     32-bit shared-memory load and mixes them as the reference's gather
//     path does (primia_tpu/ops/image.py:_clahe_channels): clamped tile
//     indices, weights clipped to [0, 1], top = v00(1-wx) + v01 wx,
//     bot = v10(1-wx) + v11 wx, out = top(1-wy) + bot wy, then the quotient
//     by 255 rounded as IEEE division rounds it (div255 below). Each
//     product and sum is rounded on its own (__fmul_rn/__fadd_rn keep nvcc
//     from contracting them into FMAs, which would round differently from
//     the plain version). The corner bytes become floats without the
//     quarter-rate int-to-float conversion (byte_float below). Rows are
//     stored contiguously, as float4 where W % 4 == 0.
//
// Bound: memory. The function reads each pixel once and writes 4 bytes a
// pixel: 5 bytes a pixel, 50.18 MB at 200 planes of 224x224, 0.0150 ms at
// 3.35 TB/s. Shared memory at 224 px: 6.1 KB of band, 8 KB of histograms,
// 16 KB of packed corners, 2 KB of LUTs and 1.6 KB of weights and tables a
// CTA, so several CTAs share an SM. PERF.md, section 6, gives its time on
// the card beside the two-kernel form it replaced.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;  // also the CTA's threads
constexpr int kWarps = kBins / 32;
constexpr int kMaxT = 8;  // the largest portable cluster
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Byte offsets of the dynamic shared memory regions; the last is the total.
struct Layout {
  int hist, pk, lut, wx, band, tcol, wy, tx0, hrow, total;
  __host__ __device__ Layout(int W, int T, int th, int tw) {
    const int ws = round16(T * tw);
    hist = 0;                     // int[T][256]
    pk = hist + T * kBins * 4;    // uint32[2][T][256]: packed corners
    lut = pk + 2 * T * kBins * 4; // uint8[T][256]: this tile row's LUTs
    wx = lut + T * kBins;         // float[W]: column weights
    band = round16(wx + 4 * W);   // uint8[th][ws]: the band of rows
    tcol = band + th * ws;        // uint8[ws]: each band column's tile, 255 past T*tw
    wy = tcol + ws;               // float[th]: row weights
    tx0 = wy + round16(4 * th);   // uint8[W]: each column's left tile
    hrow = tx0 + round16(W);      // uint8[th]: each row's h
    total = hrow + round16(th);
  }
};

__device__ __forceinline__ void copy16_async(void* dst_smem, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// v / 255 rounded to nearest, as IEEE division gives it, without its
// range check and slow path: q0 = v (1/255), then one correction with the
// exact remainder (Markstein: exact when 1/255 is rounded to nearest and
// q0 is faithful). tests/test_torch_clahe.py checks every float32 in
// [2^-30, 256). Step 5's v lies there or is 0: it is at most 255, and its
// weights and their complements are 0 or at least 1/(2 tw) and 1/(2 th),
// so a nonzero v is at least 1/(4 th tw), which the shared-memory limit
// keeps above 2^-15.
__device__ __forceinline__ float div255(float v) {
  constexpr float kInv255 = 1.0f / 255.0f;
  const float q0 = __fmul_rn(v, kInv255);
  return __fmaf_rn(__fmaf_rn(-255.0f, q0, v), kInv255, q0);
}

// Byte k of c as a float, exactly: the byte in the low mantissa bits of
// 2^23, less 2^23. Two full-rate instructions, where an int-to-float
// conversion runs at a quarter of the FP32 rate.
template <int k>
__device__ __forceinline__ float byte_float(uint32_t c) {
  return __fsub_rn(__int_as_float((int)__byte_perm(c, 0x4B000000u, 0x7440u + k)), 8388608.0f);
}

__device__ __forceinline__ float mix(uint32_t c, float wx, float wy, float one_wy) {
  const float v00 = byte_float<0>(c);
  const float v01 = byte_float<1>(c);
  const float v10 = byte_float<2>(c);
  const float v11 = byte_float<3>(c);
  const float one_wx = __fsub_rn(1.0f, wx);
  const float top = __fadd_rn(__fmul_rn(v00, one_wx), __fmul_rn(v01, wx));
  const float bot = __fadd_rn(__fmul_rn(v10, one_wx), __fmul_rn(v11, wx));
  return div255(__fadd_rn(__fmul_rn(top, one_wy), __fmul_rn(bot, wy)));
}

// T, the tiles a side, is a template argument so that the loops over the
// tiles unroll and their independent chains (shuffles, scans) interleave.
template <int T>
__global__ void __launch_bounds__(kBins)
clahe_kernel(const uint8_t* __restrict__ planes, float* __restrict__ out,
             float* __restrict__ luts_out, int H, int W, int th, int tw, float limit) {
  extern __shared__ __align__(16) uint8_t smem[];

  // every CTA of the cluster arrives at once; step 4 waits before its
  // first remote store, which needs the neighbours to run
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(W, T, th, tw);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  uint32_t* pk = reinterpret_cast<uint32_t*>(smem + L.pk);
  float* wx_s = reinterpret_cast<float*>(smem + L.wx);
  uint8_t* band = smem + L.band;
  uint8_t* tcol_s = smem + L.tcol;
  uint8_t* lut_s = smem + L.lut;
  float* wy_s = reinterpret_cast<float*>(smem + L.wy);
  uint8_t* tx0_s = smem + L.tx0;
  uint8_t* hrow_s = smem + L.hrow;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r = (int)cluster.block_rank();
  const long long n = blockIdx.x / T;
  const int Wp = T * tw;
  const int ws = round16(Wp);
  const int y0 = r * th;
  const uint8_t* plane = planes + n * H * W;

  // 1. load the band, zero the histograms, the weights of columns and rows
  const bool vec = (W & 15) == 0 && (reinterpret_cast<uintptr_t>(planes) & 15) == 0;
  if (vec) {
    const int per_row = W >> 4;
    for (int c = t; c < th * per_row; c += kBins) {
      const int i = c / per_row;
      const int x = (c - i * per_row) << 4;
      const int y = min(y0 + i, H - 1);
      copy16_async(band + i * ws + x, plane + (long long)y * W + x);
    }
    for (int c = t; c < th * (Wp - W); c += kBins) {  // columns past the edge
      const int i = c / (Wp - W);
      const int y = min(y0 + i, H - 1);
      band[i * ws + W + (c - i * (Wp - W))] = __ldg(plane + (long long)y * W + W - 1);
    }
  } else {
    for (int c = t; c < th * Wp; c += kBins) {
      const int i = c / Wp;
      const int x = c - i * Wp;
      const int y = min(y0 + i, H - 1);
      band[i * ws + x] = __ldg(plane + (long long)y * W + min(x, W - 1));
    }
  }
#pragma unroll
  for (int k = 0; k < T; ++k) hist[k * kBins + t] = 0;
  for (int x = t; x < ws; x += kBins) tcol_s[x] = x < Wp ? (uint8_t)(x / tw) : 255;
  const float half_th = 0.5f * (float)th;
  const float half_tw = 0.5f * (float)tw;
  for (int x = t; x < W; x += kBins) {
    const float fx = __fdiv_rn(__fsub_rn((float)x, half_tw), (float)tw);
    const int tx0 = min(max((int)floorf(fx), 0), T - 1);
    wx_s[x] = fminf(fmaxf(__fsub_rn(fx, (float)tx0), 0.0f), 1.0f);
    tx0_s[x] = (uint8_t)tx0;
  }
  for (int i = t; i < th; i += kBins) {
    const float fy = __fdiv_rn(__fsub_rn((float)(y0 + i), half_th), (float)th);
    const int ty0 = min(max((int)floorf(fy), 0), T - 1);
    wy_s[i] = fminf(fmaxf(__fsub_rn(fy, (float)ty0), 0.0f), 1.0f);
    hrow_s[i] = (uint8_t)(ty0 - r + 1);  // 0 or 1: fy lies in [r - 1/2, r + 1/2)
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. histograms: a thread takes 4 pixels of a band row at a time; 4
  // equal pixels of one tile (a flat region) take one atomic, others one
  // each. A warp's 128 pixels span several tiles, so a flat region's
  // atomics spread over several addresses.
  {
    const int wpr = (Wp + 3) >> 2;  // words a band row
    const int total = th * wpr;
    const int di = kBins / wpr, dj = kBins - di * wpr;
    const uint32_t* band32 = reinterpret_cast<const uint32_t*>(band);
    const uint32_t* tcol32 = reinterpret_cast<const uint32_t*>(tcol_s);
    int i = t / wpr, j = t - i * wpr;
    for (int c = t; c < total; c += kBins) {
      const uint32_t px = band32[i * (ws >> 2) + j];
      const uint32_t tl = tcol32[j];
      const uint32_t p0 = px & 255u, t0 = tl & 255u;
      if (px == p0 * 0x01010101u && tl == t0 * 0x01010101u) {
        atomicAdd(hist + t0 * kBins + p0, 4);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t tk = (tl >> (8 * k)) & 255u;
          if (tk != 255u) atomicAdd(hist + tk * kBins + ((px >> (8 * k)) & 255u), 1);
        }
      }
      j += dj;
      i += di;
      if (j >= wpr) {
        j -= wpr;
        ++i;
      }
    }
  }
  __syncthreads();

  // 3. the LUTs: warp k makes tile k's, lane l holding bins 8l .. 8l+7
  const int P = th * tw;
  for (int k = warp; k < T; k += kWarps) {
    const int4* h4 = reinterpret_cast<const int4*>(hist + k * kBins) + 2 * lane;
    const int4 a = h4[0], b = h4[1];
    const float hv[8] = {(float)a.x, (float)a.y, (float)a.z, (float)a.w,
                         (float)b.x, (float)b.y, (float)b.z, (float)b.w};
    float excess = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) excess = __fadd_rn(excess, fmaxf(__fsub_rn(hv[j], limit), 0.0f));
    // excess / 256: a power of two, so the product is the same quotient
    const float spread = __fmul_rn(warp_sum(excess), 1.0f / kBins);
    float cdf[8], sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum = __fadd_rn(sum, __fadd_rn(fminf(hv[j], limit), spread));
      cdf[j] = sum;
    }
    float before = sum;  // the lanes' totals, scanned
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFullMask, before, o);
      if (lane >= o) before = __fadd_rn(before, u);
    }
    before = __shfl_up_sync(kFullMask, before, 1);
    if (lane == 0) before = 0.0f;
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c = __fadd_rn(cdf[j], before);
      const float f =
          fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(c, (float)P), 255.0f)), 0.0f), 255.0f);
      word[j >> 2] |= (uint32_t)f << (8 * (j & 3));
      if (luts_out != nullptr) luts_out[((n * T + r) * T + k) * kBins + 8 * lane + j] = f;
    }
    *reinterpret_cast<uint2*>(lut_s + k * kBins + 8 * lane) = make_uint2(word[0], word[1]);
  }
  __syncthreads();
  uint32_t e[T];
#pragma unroll
  for (int k = 0; k < T; ++k) e[k] = lut_s[k * kBins + t];

  // 4. the corner pairs of tile row r, into this CTA's table and its
  // neighbours'; pk seen as 16-bit halves [h][tx][bin][2], the upper
  // tile row's pair in half 0, the lower's in half 1
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  uint16_t* own = reinterpret_cast<uint16_t*>(pk);
  uint16_t* above = r > 0 ? cluster.map_shared_rank(own, r - 1) : nullptr;
  uint16_t* below = r < T - 1 ? cluster.map_shared_rank(own, r + 1) : nullptr;
#pragma unroll
  for (int tx = 0; tx < T; ++tx) {
    const uint16_t pair = (uint16_t)(e[tx] | (e[tx + 1 < T ? tx + 1 : T - 1] << 8));
    const int h0 = (tx * kBins + t) * 2;        // h = 0: rows r-1, r
    const int h1 = ((T + tx) * kBins + t) * 2;  // h = 1: rows r, min(r+1, T-1)
    own[h0 + 1] = pair;
    own[h1] = pair;
    if (below != nullptr) {
      below[h0] = pair;  // row r is r+1's upper row at h = 0
    } else {
      own[h1 + 1] = pair;  // the last tile row is its own lower row
    }
    if (above != nullptr) above[h1 + 1] = pair;  // row r is r-1's lower row at h = 1
  }
  cluster.sync();

  // 5. apply to the band's own rows; a thread steps through (row, column)
  // pairs kBins apart without dividing
  const int rows = max(min(th, H - y0), 0);
  float* out_n = out + n * H * W + (long long)y0 * W;
  if ((W & 3) == 0) {
    const int quads = W >> 2;
    const int di = kBins / quads, dq = kBins - di * quads;
    int i = t / quads, q = t - i * quads;
#pragma unroll 2
    for (int c = t; c < rows * quads; c += kBins) {
      const int x = q << 2;
      const float wy = wy_s[i];
      const float one_wy = __fsub_rn(1.0f, wy);
      const uint32_t* pk_row = pk + hrow_s[i] * T * kBins;
      const uchar4 px = *reinterpret_cast<const uchar4*>(band + i * ws + x);
      const uchar4 tx = *reinterpret_cast<const uchar4*>(tx0_s + x);
      const float4 wx = *reinterpret_cast<const float4*>(wx_s + x);
      float4 o;
      o.x = mix(pk_row[tx.x * kBins + px.x], wx.x, wy, one_wy);
      o.y = mix(pk_row[tx.y * kBins + px.y], wx.y, wy, one_wy);
      o.z = mix(pk_row[tx.z * kBins + px.z], wx.z, wy, one_wy);
      o.w = mix(pk_row[tx.w * kBins + px.w], wx.w, wy, one_wy);
      *reinterpret_cast<float4*>(out_n + (long long)i * W + x) = o;
      q += dq;
      i += di;
      if (q >= quads) {
        q -= quads;
        ++i;
      }
    }
  } else {
    const int di = kBins / W, dx = kBins - di * W;
    int i = t / W, x = t - i * W;
    while (i < rows) {
      const float wy = wy_s[i];
      const uint32_t c = pk[(hrow_s[i] * T + tx0_s[x]) * kBins + band[i * ws + x]];
      out_n[(long long)i * W + x] = mix(c, wx_s[x], wy, __fsub_rn(1.0f, wy));
      x += dx;
      i += di;
      if (x >= W) {
        x -= W;
        ++i;
      }
    }
  }
}

const void* kernel_for(int T) {
  switch (T) {
    case 1: return (const void*)clahe_kernel<1>;
    case 2: return (const void*)clahe_kernel<2>;
    case 3: return (const void*)clahe_kernel<3>;
    case 4: return (const void*)clahe_kernel<4>;
    case 5: return (const void*)clahe_kernel<5>;
    case 6: return (const void*)clahe_kernel<6>;
    case 7: return (const void*)clahe_kernel<7>;
    default: return (const void*)clahe_kernel<8>;
  }
}

// A cluster of T CTAs a plane, N planes, the dynamic shared memory set.
cudaError_t configure(const void* kernel, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int N, int W, int T, int th, int tw, cudaStream_t stream) {
  const int smem = Layout(W, T, th, tw).total;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)T;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(N * T));
  cfg->blockDim = dim3(kBins);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory a CTA needs, in bytes.
int clahe_smem_bytes(int W, int T, int th, int tw) { return Layout(W, T, th, tw).total; }

// planes: (N, H, W) uint8; out: (N, H, W) float32 in [0, 1]; luts_out: null,
// or (N, T*T, 256) float32, tile-major. A cluster of T CTAs a plane.
int clahe(const void* planes, void* out, void* luts_out, int N, int H, int W, int T, int th,
          int tw, float limit, void* stream) {
  if (N <= 0 || T < 1 || T > kMaxT || (long long)N * T > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = kernel_for(T);
  cudaError_t e = configure(kernel, &cfg, &attr, N, W, T, th, tw, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&planes, &out, &luts_out, &H, &W, &th, &tw, &limit};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of T CTAs that the card holds at once with this shared memory
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
int clahe_max_active_clusters(int W, int T, int th, int tw) {
  if (T < 1 || T > kMaxT) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = kernel_for(T);
  cudaError_t e = configure(kernel, &cfg, &attr, 1, W, T, th, tw, nullptr);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

const char* clahe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
