// CLAHE (contrast-limited adaptive histogram equalisation) for Hopper.
//
// Two kernels, bound to Python through the plain C launchers at the end
// (loaded with ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_clahe.py, which also holds their plain PyTorch
// versions):
//
//   clahe_kernel (K3)  (N, H, W) uint8 planes -> (N, H, W) float32 in [0, 1]
//   clahe_lab_kernel   (N, 3, H, W) float32 RGB in [0, 1] -> (N, 3, H, W)
//                      float32 RGB, equalised on the L channel of 8-bit LAB
//
// clahe_kernel replaces both TPU kernels of primia_tpu/ops/pallas_clahe.py
// and the division after them, the whole of _clahe_pallas_impl: _lut_kernel
// (the per-tile clipped-histogram LUTs, pallas_call in _lut_stage),
// _apply_kernel (the bilinear mix of four tiles' LUTs, the second
// pallas_call) and the final `/ 255.0`.
//
// clahe_lab_kernel replaces the same two TPU kernels together with the LAB
// conversion that XLA fuses around them in the JAX chain's 3-channel CLAHE
// (primia_tpu/ops/image.py:clahe: rgb_to_lab_u8, the rounding to uint8,
// lab_u8_to_rgb). Written as PyTorch around clahe_kernel, that conversion is
// some 140 elementwise launches, each reading and writing a whole batch.
//
// Tile geometry: T tiles a side, each th = ceil(H/T) by tw = ceil(W/T)
// pixels; rows and columns past the image edge read the edge pixel, which
// is the reference's "edge" padding.
//
// Design: one thread-block cluster of T CTAs a plane or image (T <= 8, the
// portable cluster size); CTA r of the cluster owns tile row r.
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
//     is a multiple of 2^-12 below 2^10 at 224 px (28x28 tiles), a
//     multiple of 2^-8 below 2^12 at 384 px (48x48 tiles, limit 9), and an
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
// clahe_lab_kernel shares steps 2-4 and changes the two ends:
//  1. Load. Each band pixel's three float32 channels are read through the
//     caller's strides (contiguous NCHW, or the NHWC images of the predict
//     steps seen as NCHW, with no copy), and the pixel becomes what
//     rgb_to_lab_u8 and torch.round(...).to(uint8) make of it: 8-bit levels
//     (floor(x 255 + 0.5) clamped), the sRGB companding removed by a
//     256-entry table that the wrapper makes with the plain function itself
//     (so it equals it bit for bit), the XYZ matrix, cube roots as
//     powf(t, 1/3) (the plain path's pow), L, a, b, the clamp, rint. L goes
//     into the band where clahe_kernel keeps its plane, a and b into two
//     more bands (2 th T tw bytes, 12.25 KB at 224 px). The plain path
//     quantises L / 255 again (x 255 + 0.5, truncated), which gives back L
//     on all 256 levels (tests/test_torch_clahe.py), so the band holds L.
//  5. Apply. The mixed L is L_eq as in clahe_kernel; then rint(L_eq 255) as
//     the plain path rounds it, and lab_u8_to_rgb of (L', a, b) in
//     registers: f^-1 by cubes, the inverse matrix, the clamps, the sRGB
//     companding with powf(y, 1/2.4), floor(v 255 + 0.5) / 255. Three
//     float32 stores through the output's strides.
//     As in step 5 above, every product, sum and quotient is rounded on its
//     own, in the plain path's order, with IEEE division, and the constants
//     are the float32 values PyTorch rounds the plain path's Python numbers
//     to (the wrapper passes them: LabConsts), so the kernel computes the
//     plain composition's numbers on the card. No fast-math flag.
//
// Bound, clahe_kernel: memory. The function reads each pixel once and
// writes 4 bytes a pixel: 5 bytes a pixel, 50.18 MB at 200 planes of
// 224x224, 0.0150 ms at 3.35 TB/s. Shared memory at 224 px: 6.1 KB of band,
// 8 KB of histograms, 16 KB of packed corners, 2 KB of LUTs and 1.6 KB of
// weights and tables a CTA, so several CTAs share an SM. PERF.md, section
// 6, gives its time on the card beside the two-kernel form it replaced.
//
// Bound, clahe_lab_kernel: memory, 12 bytes read and 12 written a pixel:
// 240.8 MB at 200 images of 224x224, 0.0719 ms at 3.35 TB/s. Its six powf a
// pixel take two special-function operations each, 120 M at that shape,
// 0.029 ms at 16 a clock on 132 SMs at 1.98 GHz; the rest of its
// arithmetic, some 300 float32 instructions a pixel (the divisions are
// IEEE quotients, the powf full-accuracy), is its practical limit.
// Shared memory at 224 px: 47.6 KB a CTA (clahe_kernel's, the a and b bands
// and the 1 KB table).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;  // also the CTA's threads
constexpr int kWarps = kBins / 32;
constexpr int kMaxT = 8;  // the largest portable cluster
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Byte offsets of the dynamic shared memory regions; the last is the total.
struct Layout {
  int hist, pk, lut, wx, band, tcol, wy, tx0, hrow, ab, lin, total;
  __host__ __device__ Layout(int W, int T, int th, int tw, bool lab) {
    const int ws = round16(T * tw);
    hist = 0;                     // int[T][256]
    pk = hist + T * kBins * 4;    // uint32[2][T][256]: packed corners
    lut = pk + 2 * T * kBins * 4; // uint8[T][256]: this tile row's LUTs
    wx = lut + T * kBins;         // float[W]: column weights
    band = round16(wx + 4 * W);   // uint8[th][ws]: the band of rows (L for LAB)
    tcol = band + th * ws;        // uint8[ws]: each band column's tile, 255 past T*tw
    wy = tcol + ws;               // float[th]: row weights
    tx0 = wy + round16(4 * th);   // uint8[W]: each column's left tile
    hrow = tx0 + round16(W);      // uint8[th]: each row's h
    ab = hrow + round16(th);      // LAB: uint8[2][th][ws], the band's a and b
    lin = ab + (lab ? 2 * th * ws : 0);   // LAB: float[256], the sRGB levels made linear
    total = lin + (lab ? 4 * kBins : 0);
  }
};

// The float32 constants of rgb_to_lab_u8 and lab_u8_to_rgb, in the order of
// ops/cuda_clahe.py:lab_constants: each Python number of the plain path as
// PyTorch rounds it to float32. Passed by value as a __grid_constant__
// kernel parameter: read from the constant bank, never copied.
struct LabConsts {
  float rgb2xyz[9];   // _RGB2XYZ, row-major
  float xyz2rgb[9];   // _XYZ2RGB
  float xn, zn;       // the white point's X and Z
  float eps;          // (6/29)^3
  float kappa;        // 903.3
  float kappa_eps;    // kappa * eps
  float third;        // 1/3, the cube root's exponent
  float slope;        // 7.787, f's linear segment
  float offset;       // 16/116
  float l_scale;      // 255/100: L to its byte scale
  float l_unscale;    // 100/255
  float knee;         // 0.0031308, where the sRGB curve turns linear
  float srgb_slope;   // 12.92
  float inv_gamma;    // 1/2.4
  float srgb_scale;   // 1.055
  float srgb_offset;  // 0.055
};

// Element strides of an (N, 3, H, W) float32 tensor.
struct Strides {
  long long n, c, y, x;
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
// keeps above 2^-15. clahe_lab_kernel's last quotients divide integers in
// [0, 255].
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

// ------------------------------------------------ steps both kernels share

// Step 1's tables: zeroed histograms, each band column's tile, each
// column's left tile and weight, each band row's weight and upper tile row.
template <int T>
__device__ __forceinline__ void init_tables(uint8_t* smem, const Layout& L, int W, int th,
                                            int tw, int r) {
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  float* wx_s = reinterpret_cast<float*>(smem + L.wx);
  uint8_t* tcol_s = smem + L.tcol;
  float* wy_s = reinterpret_cast<float*>(smem + L.wy);
  uint8_t* tx0_s = smem + L.tx0;
  uint8_t* hrow_s = smem + L.hrow;
  const int t = threadIdx.x;
  const int Wp = T * tw;
  const int ws = round16(Wp);
  const int y0 = r * th;
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
}

// 2. histograms: a thread takes 4 pixels of a band row at a time; 4 equal
// pixels of one tile (a flat region) take one atomic, others one each. A
// warp's 128 pixels span several tiles, so a flat region's atomics spread
// over several addresses.
template <int T>
__device__ __forceinline__ void histograms(uint8_t* smem, const Layout& L, int th, int tw) {
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  const int t = threadIdx.x;
  const int Wp = T * tw;
  const int ws = round16(Wp);
  const int wpr = (Wp + 3) >> 2;  // words a band row
  const int total = th * wpr;
  const int di = kBins / wpr, dj = kBins - di * wpr;
  const uint32_t* band32 = reinterpret_cast<const uint32_t*>(smem + L.band);
  const uint32_t* tcol32 = reinterpret_cast<const uint32_t*>(smem + L.tcol);
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

// 3. the LUTs: warp k makes tile k's, lane l holding bins 8l .. 8l+7; then
// 4. the corner pairs of tile row r, into this CTA's table and its
// neighbours'. Starts after the histograms' barrier; on return the packed
// corners of this CTA are complete.
template <int T>
__device__ __forceinline__ void luts_and_corners(uint8_t* smem, const Layout& L, int th, int tw,
                                                 float limit, float* __restrict__ luts_out,
                                                 long long n, int r) {
  cg::cluster_group cluster = cg::this_cluster();
  const int* hist = reinterpret_cast<const int*>(smem + L.hist);
  uint8_t* lut_s = smem + L.lut;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
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

  // pk seen as 16-bit halves [h][tx][bin][2], the upper tile row's pair in
  // half 0, the lower's in half 1
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  uint16_t* own = reinterpret_cast<uint16_t*>(smem + L.pk);
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
}

// ------------------------------------------------------------ clahe_kernel

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
  const Layout L(W, T, th, tw, false);
  uint32_t* pk = reinterpret_cast<uint32_t*>(smem + L.pk);
  const float* wx_s = reinterpret_cast<const float*>(smem + L.wx);
  uint8_t* band = smem + L.band;
  const float* wy_s = reinterpret_cast<const float*>(smem + L.wy);
  const uint8_t* tx0_s = smem + L.tx0;
  const uint8_t* hrow_s = smem + L.hrow;

  const int t = threadIdx.x;
  const int r = (int)cg::this_cluster().block_rank();
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
  init_tables<T>(smem, L, W, th, tw, r);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  histograms<T>(smem, L, th, tw);
  __syncthreads();
  luts_and_corners<T>(smem, L, th, tw, limit, luts_out, n, r);

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

// -------------------------------------------------------- clahe_lab_kernel

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// a0 x + a1 y + a2 z as PyTorch evaluates it, each product and sum rounded
__device__ __forceinline__ float dot3(const float* a, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], x), __fmul_rn(a[1], y)), __fmul_rn(a[2], z));
}

// floor((v 255 + 0.5).clamp(0, 255)): an RGB value's 8-bit level
__device__ __forceinline__ int level(float v) {
  return (int)floorf(clamp(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f), 0.0f, 255.0f));
}

// torch.round(v.clamp(0, 255)).to(uint8)
__device__ __forceinline__ uint32_t to_byte(float v) {
  return (uint32_t)rintf(clamp(v, 0.0f, 255.0f));
}

// CIELAB's f: the cube root above eps, its linear segment below
__device__ __forceinline__ float lab_f(float t, const LabConsts& k) {
  return t > k.eps ? powf(t, k.third) : __fadd_rn(__fmul_rn(t, k.slope), k.offset);
}

// rgb_to_lab_u8 of one pixel and the rounding to uint8 after it, packed
// L | a << 8 | b << 16; lin holds _srgb_to_linear of the 256 levels
__device__ __forceinline__ uint32_t rgb_to_lab(float r, float g, float b, const float* lin,
                                               const LabConsts& k) {
  const float R = lin[level(r)], G = lin[level(g)], B = lin[level(b)];
  const float xr = __fdiv_rn(dot3(k.rgb2xyz, R, G, B), k.xn);
  const float yr = dot3(k.rgb2xyz + 3, R, G, B);
  const float zr = __fdiv_rn(dot3(k.rgb2xyz + 6, R, G, B), k.zn);
  const float fx = lab_f(xr, k), fy = lab_f(yr, k), fz = lab_f(zr, k);
  const float L = yr > k.eps ? __fsub_rn(__fmul_rn(fy, 116.0f), 16.0f) : __fmul_rn(yr, k.kappa);
  const float A = __fadd_rn(__fmul_rn(__fsub_rn(fx, fy), 500.0f), 128.0f);
  const float Bv = __fadd_rn(__fmul_rn(__fsub_rn(fy, fz), 200.0f), 128.0f);
  return to_byte(__fmul_rn(L, k.l_scale)) | to_byte(A) << 8 | to_byte(Bv) << 16;
}

// lab_u8_to_rgb's inverse of f
__device__ __forceinline__ float lab_finv(float t, const LabConsts& k) {
  const float t3 = __fmul_rn(__fmul_rn(t, t), t);
  return t3 > k.eps ? t3 : __fdiv_rn(__fsub_rn(t, k.offset), k.slope);
}

// One linear channel -> _linear_to_srgb of it clamped to [0, 1], clamped
// again, then floor(s 255 + 0.5) / 255
__device__ __forceinline__ float srgb_level(float v, const LabConsts& k) {
  v = clamp(v, 0.0f, 1.0f);
  const float s = v <= k.knee ? __fmul_rn(v, k.srgb_slope)
                              : __fsub_rn(__fmul_rn(powf(fmaxf(v, 0.0f), k.inv_gamma),
                                                    k.srgb_scale),
                                          k.srgb_offset);
  return div255(floorf(__fadd_rn(__fmul_rn(clamp(s, 0.0f, 1.0f), 255.0f), 0.5f)));
}

// lab_u8_to_rgb of the bytes (L, a, b), given as floats
__device__ __forceinline__ float3 lab_to_rgb(float Lb, float ab, float bb, const LabConsts& k) {
  const float L = __fmul_rn(Lb, k.l_unscale);
  const float fy = __fdiv_rn(__fadd_rn(L, 16.0f), 116.0f);
  const float fx = __fadd_rn(fy, __fdiv_rn(__fsub_rn(ab, 128.0f), 500.0f));
  const float fz = __fsub_rn(fy, __fdiv_rn(__fsub_rn(bb, 128.0f), 200.0f));
  const float y = L > k.kappa_eps ? __fmul_rn(__fmul_rn(fy, fy), fy) : __fdiv_rn(L, k.kappa);
  const float x = __fmul_rn(lab_finv(fx, k), k.xn);
  const float z = __fmul_rn(lab_finv(fz, k), k.zn);
  return make_float3(srgb_level(dot3(k.xyz2rgb, x, y, z), k),
                     srgb_level(dot3(k.xyz2rgb + 3, x, y, z), k),
                     srgb_level(dot3(k.xyz2rgb + 6, x, y, z), k));
}

template <int T>
__global__ void __launch_bounds__(kBins)
clahe_lab_kernel(const float* __restrict__ rgb, float* __restrict__ out,
                 const float* __restrict__ lin_levels, const __grid_constant__ LabConsts k,
                 const __grid_constant__ Strides si, const __grid_constant__ Strides so, int H,
                 int W, int th, int tw, float limit) {
  extern __shared__ __align__(16) uint8_t smem[];

  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const Layout L(W, T, th, tw, true);
  const uint32_t* pk = reinterpret_cast<const uint32_t*>(smem + L.pk);
  const float* wx_s = reinterpret_cast<const float*>(smem + L.wx);
  uint8_t* band = smem + L.band;
  const float* wy_s = reinterpret_cast<const float*>(smem + L.wy);
  const uint8_t* tx0_s = smem + L.tx0;
  const uint8_t* hrow_s = smem + L.hrow;
  float* lin = reinterpret_cast<float*>(smem + L.lin);

  const int t = threadIdx.x;
  const int r = (int)cg::this_cluster().block_rank();
  const long long n = blockIdx.x / T;
  const int Wp = T * tw;
  const int ws = round16(Wp);
  const int y0 = r * th;
  uint8_t* a_s = smem + L.ab;
  uint8_t* b_s = a_s + th * ws;

  lin[t] = __ldg(lin_levels + t);  // kBins threads, 256 levels
  init_tables<T>(smem, L, W, th, tw, r);
  __syncthreads();

  // 1. the band's pixels, edge-clamped, to L, a, b bytes; a thread steps
  // through (row, column) pairs kBins apart without dividing
  {
    const float* img = rgb + n * si.n;
    const int di = kBins / Wp, dx = kBins - di * Wp;
    int i = t / Wp, x = t - i * Wp;
    while (i < th) {
      const float* p =
          img + (long long)min(y0 + i, H - 1) * si.y + (long long)min(x, W - 1) * si.x;
      const uint32_t lab = rgb_to_lab(__ldg(p), __ldg(p + si.c), __ldg(p + 2 * si.c), lin, k);
      const int o = i * ws + x;
      band[o] = (uint8_t)lab;
      a_s[o] = (uint8_t)(lab >> 8);
      b_s[o] = (uint8_t)(lab >> 16);
      x += dx;
      i += di;
      if (x >= Wp) {
        x -= Wp;
        ++i;
      }
    }
  }
  __syncthreads();

  histograms<T>(smem, L, th, tw);
  __syncthreads();
  luts_and_corners<T>(smem, L, th, tw, limit, nullptr, n, r);

  // 5. apply to the band's own rows, back to RGB
  const int rows = max(min(th, H - y0), 0);
  float* out_n = out + n * so.n + (long long)y0 * so.y;
  const int di = kBins / W, dx = kBins - di * W;
  int i = t / W, x = t - i * W;
  while (i < rows) {
    const float wy = wy_s[i];
    const int o = i * ws + x;
    const uint32_t c = pk[(hrow_s[i] * T + tx0_s[x]) * kBins + band[o]];
    const float l_eq = mix(c, wx_s[x], wy, __fsub_rn(1.0f, wy));
    const float3 v =
        lab_to_rgb(rintf(__fmul_rn(l_eq, 255.0f)), (float)a_s[o], (float)b_s[o], k);
    float* q = out_n + (long long)i * so.y + (long long)x * so.x;
    q[0] = v.x;
    q[so.c] = v.y;
    q[2 * so.c] = v.z;
    x += dx;
    i += di;
    if (x >= W) {
      x -= W;
      ++i;
    }
  }
}

// ------------------------------------------------------------ the launchers

const void* kernel_for(int T, bool lab) {
  switch (T) {
    case 1: return lab ? (const void*)clahe_lab_kernel<1> : (const void*)clahe_kernel<1>;
    case 2: return lab ? (const void*)clahe_lab_kernel<2> : (const void*)clahe_kernel<2>;
    case 3: return lab ? (const void*)clahe_lab_kernel<3> : (const void*)clahe_kernel<3>;
    case 4: return lab ? (const void*)clahe_lab_kernel<4> : (const void*)clahe_kernel<4>;
    case 5: return lab ? (const void*)clahe_lab_kernel<5> : (const void*)clahe_kernel<5>;
    case 6: return lab ? (const void*)clahe_lab_kernel<6> : (const void*)clahe_kernel<6>;
    case 7: return lab ? (const void*)clahe_lab_kernel<7> : (const void*)clahe_kernel<7>;
    default: return lab ? (const void*)clahe_lab_kernel<8> : (const void*)clahe_kernel<8>;
  }
}

// A cluster of T CTAs a plane or image, N of them, the dynamic shared
// memory set.
cudaError_t configure(const void* kernel, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int N, int W, int T, int th, int tw, bool lab, cudaStream_t stream) {
  const int smem = Layout(W, T, th, tw, lab).total;
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

bool bad_grid(int N, int T) {
  return N <= 0 || T < 1 || T > kMaxT || (long long)N * T > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Dynamic shared memory a CTA needs, in bytes; lab != 0 for clahe_lab.
int clahe_smem_bytes(int W, int T, int th, int tw, int lab) {
  return Layout(W, T, th, tw, lab != 0).total;
}

// Floats in LabConsts: the length of the array clahe_lab takes.
int clahe_lab_consts() { return (int)(sizeof(LabConsts) / sizeof(float)); }

// planes: (N, H, W) uint8; out: (N, H, W) float32 in [0, 1]; luts_out: null,
// or (N, T*T, 256) float32, tile-major. A cluster of T CTAs a plane.
int clahe(const void* planes, void* out, void* luts_out, int N, int H, int W, int T, int th,
          int tw, float limit, void* stream) {
  if (bad_grid(N, T)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = kernel_for(T, false);
  cudaError_t e = configure(kernel, &cfg, &attr, N, W, T, th, tw, false, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&planes, &out, &luts_out, &H, &W, &th, &tw, &limit};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// rgb, out: (N, 3, H, W) float32 with the element strides in_strides and
// out_strides (n, c, y, x); lin_levels: 256 float32 on the device;
// consts: clahe_lab_consts() floats on the host. A cluster of T CTAs an
// image.
int clahe_lab(const void* rgb, void* out, const void* lin_levels, const float* consts,
              const long long* in_strides, const long long* out_strides, int N, int H, int W,
              int T, int th, int tw, float limit, void* stream) {
  if (bad_grid(N, T)) return (int)cudaErrorInvalidValue;
  LabConsts k;
  memcpy(&k, consts, sizeof k);
  Strides si, so;
  memcpy(&si, in_strides, sizeof si);
  memcpy(&so, out_strides, sizeof so);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = kernel_for(T, true);
  cudaError_t e = configure(kernel, &cfg, &attr, N, W, T, th, tw, true, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&rgb, &out, (void*)&lin_levels, &k, &si, &so, &H, &W, &th, &tw, &limit};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Clusters of T CTAs that the card holds at once with this shared memory
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
int clahe_max_active_clusters(int W, int T, int th, int tw, int lab) {
  if (T < 1 || T > kMaxT) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kernel = kernel_for(T, lab != 0);
  cudaError_t e = configure(kernel, &cfg, &attr, 1, W, T, th, tw, lab != 0, nullptr);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

const char* clahe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
