// The weight gradient of a 3x3, stride-1, pad-1 convolution for Hopper, on
// the tensor cores (bf16 in, f32 accumulate) through wgmma, fed by TMA.
//
// Bound to Python through the plain C launchers at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_wgrad.py, which also holds its plain PyTorch
// version and plan_wgrad, the host-side plan every launch follows).
//
// conv3x3_wgrad_kernel (K7)
//   Replaces the TPU kernels primia_tpu/ops/pallas_wgrad.py:_wgrad_kernel
//   (pallas_call in conv3x3_wgrad_pallas) and _wgrad_kernel_v2 (pallas_call
//   in conv3x3_wgrad_pallas_v2). The two differ only in where the TPU builds
//   its halos; here TMA's zero fill is the halo, so one kernel serves both.
//
//     dW[o, c, kh, kw] = sum_{b,h,w} x[b, h+kh-1, w+kw-1, c] * g[b, h, w, o]
//
//   (zero outside the image), with x (B, H, W, ci) and g (B, H, W, co) in
//   NHWC memory (channels_last NCHW tensors) and dW OIHW float32.
//
//   It keeps the TPU kernel's folding: one GEMM whose M indexes (kh, x
//   channel), N indexes (kw, g channel) and K the pixels p = (b, h, w),
//
//     A[(kh, c)][p] = x[b, h+kh-1, w, c]      B[p][(kw, o)] = g[b, h, w-kw+1, o]
//
//   (shifting g by -kw instead of x by +kw lets one pixel index serve all
//   nine taps). A block's tile is the whole 3 x 3 kernel of one 64-channel
//   block of x against one of g: 192 x 192 of (M, N), three 64-row taps kh
//   by three 64-column taps kw. Its operands come by TMA as boxes of the
//   4-D tensors (C, W, H, B), innermost first, 64 channels (128 bytes, one
//   128-byte swizzle row) x wb columns x rows x 1 image, and TMA fills with
//   zeros whatever lies outside the tensor: the halo, the channel tail past
//   ci or co, and the rows and columns past the image's last (g's zeros
//   there cancel x's values, and x's zeros past its last column cancel
//   g's). The kernel does no index arithmetic per pixel.
//     - A stage covers K = wb * hb pixels (a multiple of 16, at most 112:
//       28 x 4 at layer2, 14 x 8 at layer3).
//     - x comes as one box of hb + 2 rows, from row h0 - 1; tap kh reads it
//       from its row kh, so the three row taps share one load (A's bytes
//       (hb + 2) / (3 hb) of three boxes).
//     - g comes as three boxes of hb rows, box kw from column w0 + 1 - kw.
//     - Each lands as 128-byte rows, one a pixel, MN-major, in the layout
//       wgmma's 128-byte-swizzled descriptor reads; a start off the
//       swizzle's 1024-byte period (tap kh at row kh * wb) needs no base
//       offset (smem_desc).
//
//   Pipeline: a ring of 3 stages in dynamic shared memory (65 KB a stage
//   at layer2), each with a "full" mbarrier (TMA's byte count) and an
//   "empty" one (the consumers' release); one producer warp, one thread of
//   which issues a stage's four TMA loads; three consumer warpgroups, one
//   per kh, each running wgmma m64n192k16 (both operands MN-major from
//   shared memory, f32 accumulators in 96 registers a thread), keeping one
//   stage's products in flight while it waits for the next.
//   L2 traffic: at 192 x 192 a stage's 112 pixels bring 64 KB for 8.3
//   MFLOP (128 FLOP a byte, against 77 at a 128 x 192 tile of separate
//   per-tap boxes): 0.37 GB a call at layer2. Multicasting the shared
//   boxes within thread-block clusters cut that further but not the time
//   (PERF.md), so the blocks run alone.
//
//   K is long (1,400 boxes at layer2, 400 at layer3) and the tiles few (4
//   and 16), so K is split across blocks, as many as one wave holds (one
//   block an SM). Each block writes its tile, through shared memory, as
//   its split's whole dW (co, ci, 3, 3) slice: each output channel's 64 x
//   9 values one contiguous run. conv3x3_wgrad_reduce_kernel then sums the
//   splits elementwise in a fixed order. No atomics: the result is
//   deterministic.
//
//   Bound: operations. At the train step's shapes (200 x 128 x 28 x 28 and
//   200 x 256 x 14 x 14) one call is 2 * 9 * ci * co * B*H*W = 46.24 GFLOP:
//   0.0467 ms at 989 TFLOP/s (dense bf16); it moves 80 MB (0.024 ms at
//   3.35 TB/s). At layer3 the boxes pad H = 14 to 16 rows, 14% more
//   products than the bound counts. On the card (NVIDIA H100 80GB HBM3,
//   700 W): PERF.md, section 6, gives this kernel's time beside the
//   wmma/cp.async kernel it replaced (0.306 ms a call) and cuDNN's
//   conv2d_weight (0.081 ms).

#include <cuda.h>  // CUtensorMap and its enums; libcuda's entry is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BOX_CHANNELS = 64;  // a box's channels: one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int TAPS = 3;           // kh: one consumer warpgroup each, on the tile's one x box
constexpr int N_BOXES = 3;        // g boxes a stage, one per kw: the tile's 192 columns
constexpr int BN = 64 * N_BOXES;
constexpr int CONSUMER_THREADS = 128 * TAPS;
constexpr int THREADS = CONSUMER_THREADS + 32;  // and one producer warp
constexpr int ACC = BN / 2;                     // f32 accumulators a thread (m64n192)
// The epilogue's tile in shared memory: row c * 3 + kh, column o * 3 + kw,
// a pitch of 195 floats (3 mod 32), so that a warp reading one output
// channel's (c, kh, kw) run meets each bank once.
constexpr int TILE_PITCH = BN + 3;
constexpr int TILE_BYTES = TAPS * BOX_CHANNELS * TILE_PITCH * 4;
constexpr int MAX_STAGES = 8;
constexpr int MAX_BOX_DIM = 256;    // TMA's limit on a box's extent
constexpr int MAX_ROWS = 256;       // pixels a g box, at most
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can have on sm_90
// the ring's base is aligned up to 1024 bytes (the 128-byte swizzle's
// period), then the stages (or, at the end, the epilogue's tile, whichever
// is larger), then a full and an empty mbarrier per stage
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_STAGES * 8;

struct Plan {
  float* ws;             // (splits, co, ci, 3, 3) float32
  int ci, co;
  int tiles_n;           // ceil(co / 64): g's channel blocks
  int wb, hb, nwb, nhb;  // a box's columns and rows; boxes an image along W and H
  int rows;              // wb * hb pixels a g box, and a stage's K
  int x_bytes;           // the x box (wb x (hb + 2) pixels), rounded up to 1024 bytes
  int boxes;             // B * nhb * nwb
  int per_split;         // boxes a split
  int stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// counted on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor of wgmma, 128-byte swizzle. For an
// MN-major operand the leading byte offset steps from one 64-element block
// of M (or N) to the next, the stride byte offset from one 8-row group of K
// to the next. The swizzle follows the address bits, so a start off its
// 1024-byte period (an x box read from row kh * wb) needs no base offset:
// with (addr >> 7) & 7 in that field the products came out wrong on the
// H100, with 0 right.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) * B (16 x 192); both operands MN-major (transposed), bf16.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgrad_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
                     const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t box_bytes = (uint32_t)p.rows * ROW_BYTES;  // a multiple of 2048
  const uint32_t stage_bytes = (uint32_t)p.x_bytes + N_BOXES * box_bytes;
  // full[s] = full0 + 8 s, past the ring and the epilogue's tile
  const uint32_t full0 = base + max((uint32_t)p.stages * stage_bytes, (uint32_t)TILE_BYTES);
  const uint32_t empty0 = full0 + MAX_STAGES * 8;

  const int tm = blockIdx.x / p.tiles_n;  // x's channel block
  const int tn = blockIdx.x % p.tiles_n;  // g's channel block
  const int j0 = blockIdx.y * p.per_split;
  const int nbox = min(p.per_split, p.boxes - j0);
  const int wg = threadIdx.x / 128;  // a consumer warpgroup's kh

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, TAPS);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warp
    if (threadIdx.x == CONSUMER_THREADS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tg)) : "memory");
      const uint32_t tx_bytes = (uint32_t)(p.wb * (p.hb + 2) * ROW_BYTES) + N_BOXES * box_bytes;
      for (int it = 0; it < nbox; ++it) {
        const int s = it % p.stages;
        mbar_wait(empty0 + 8 * s, ((it / p.stages) & 1) ^ 1);  // a fresh stage passes
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, tx_bytes);
        int j = j0 + it;
        const int wbk = j % p.nwb;
        j /= p.nwb;
        const int hbk = j % p.nhb;
        const int b = j / p.nhb;
        const int w0 = wbk * p.wb, h0 = hbk * p.hb;
        const uint32_t st = base + (uint32_t)s * stage_bytes;
        // the x box, rows h0-1 .. h0+hb; g box kw, columns from w0+1-kw
        tma_load_4d(st, &tx, full, tm * BOX_CHANNELS, w0, h0 - 1, b);
        for (int kw = 0; kw < N_BOXES; ++kw)
          tma_load_4d(st + p.x_bytes + kw * box_bytes, &tg, full, tn * BOX_CHANNELS,
                      w0 + 1 - kw, h0, b);
      }
    }
    return;
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  const int ksteps = p.rows / 16;
  for (int it = 0; it < nbox; ++it) {
    const int s = it % p.stages;
    mbar_wait(full0 + 8 * s, (it / p.stages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp leaves the wait together
    // tap kh reads the x box from its row kh: x rows h0+kh-1 ..
    const uint32_t a0 = base + (uint32_t)s * stage_bytes + (uint32_t)(wg * p.wb) * ROW_BYTES;
    const uint32_t b0 = base + (uint32_t)s * stage_bytes + p.x_bytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int k = 0; k < ksteps; ++k) {
      // 16 pixels = 16 rows of 128 bytes = 2048 bytes further along K
      wgmma_m64n192k16(acc, smem_desc(a0 + 2048u * k, 8 * ROW_BYTES, 8 * ROW_BYTES),
                       smem_desc(b0 + 2048u * k, box_bytes, 8 * ROW_BYTES));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (it > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * ((it - 1) % p.stages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // The tile is the whole 3 x 3 kernel of x's block tm and g's block tn:
  // through shared memory (the ring is free once every consumer is past its
  // last stage) it goes out as this split's dW, each output channel's 64 x
  // 9 (c, kh, kw) values one contiguous run. The accumulator layout of
  // m64nN: warp w of the warpgroup holds rows 16w + lane/4 (+8); register
  // 4j + {0,1} columns 8j + 2(lane%4) (+1), 4j + {2,3} the same columns 8
  // rows down: row c of tap kh = wg, column kw * 64 + o.
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  float* tile = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int c = warp * 16 + lane / 4;
    float* row0 = tile + (c * 3 + wg) * TILE_PITCH;
    float* row8 = row0 + 24 * TILE_PITCH;  // c + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int kw = j / 8, o = (j % 8) * 8 + 2 * (lane % 4);
      row0[o * 3 + kw] = acc[4 * j];
      row0[o * 3 + 3 + kw] = acc[4 * j + 1];
      row8[o * 3 + kw] = acc[4 * j + 2];
      row8[o * 3 + 3 + kw] = acc[4 * j + 3];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  const int c0 = tm * BOX_CHANNELS, o0 = tn * BOX_CHANNELS;
  const int nc = min(BOX_CHANNELS, p.ci - c0), no = min(BOX_CHANNELS, p.co - o0);
  float* out = p.ws + (long long)blockIdx.y * p.co * p.ci * 9;
  for (int o = 0; o < no; ++o) {
    float* run = out + ((long long)(o0 + o) * p.ci + c0) * 9;
    for (int e = threadIdx.x; e < nc * 9; e += CONSUMER_THREADS) {
      const int ckh = e / 3, kw = e - ckh * 3;  // ckh = c * 3 + kh
      run[e] = tile[ckh * TILE_PITCH + o * 3 + kw];
    }
  }
}

// dW = the sum of the splits' dW in split order, four values a thread.
__global__ void __launch_bounds__(256)
conv3x3_wgrad_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ dw, int splits,
                            long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = ws[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = ws[k * n4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  dw[i] = s;
}

// cuTensorMapEncodeTiled, from the libcuda that the CUDA runtime has
// loaded: this library links none of its own.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// The 4-D map (C, W, H, B) of an NHWC bf16 tensor, boxes of 64 channels x wb
// x hb x 1, 128-byte swizzle, zeros outside.
bool encode_map(CUtensorMap* map, const void* t, int B, int H, int W, int C, int wb, int hb) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {BOX_CHANNELS, (cuuint32_t)wb, (cuuint32_t)hb, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The x box's bytes (wb x (hb + 2) pixels), rounded up so that the g boxes
// after it start on the swizzle's 1024-byte period.
int x_box_bytes(int wb, int hb) { return (wb * (hb + 2) * ROW_BYTES + 1023) / 1024 * 1024; }

// The ring (or the epilogue's tile it holds at the end, whichever is
// larger) and the mbarriers.
long long smem_bytes(int wb, int hb, int stages) {
  const long long ring =
      (long long)stages * (x_box_bytes(wb, hb) + N_BOXES * wb * hb * ROW_BYTES);
  return (ring > TILE_BYTES ? ring : TILE_BYTES) + SMEM_EXTRA;
}

}  // namespace

extern "C" {

// Blocks of conv3x3_wgrad_kernel an SM holds with `smem` bytes of dynamic
// shared memory, from the kernel's registers, threads and that memory; < 0:
// a CUDA error, negated.
int conv3x3_wgrad_blocks_per_sm(int smem) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv3x3_wgrad_kernel, THREADS,
                                                      smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// x: (B, H, W, ci) bf16 and g: (B, H, W, co) bf16 in NHWC memory, 16-byte
// aligned; ws: (splits, co, ci, 3, 3) and dw: (co, ci, 3, 3) float32, 16-byte
// aligned. Boxes of wb x hb pixels (wb*hb a multiple of 16); each split
// covers per_split boxes of the B * ceil(H/hb) * ceil(W/wb) in (image, box
// row, box column) order.
int conv3x3_wgrad(const void* x, const void* g, void* ws, void* dw, int B, int H, int W, int ci,
                  int co, int wb, int hb, int splits, int per_split, int stages, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || ci <= 0 || co <= 0 || ci % 8 != 0 || co % 8 != 0 ||
      wb <= 0 || hb <= 0 || wb > MAX_BOX_DIM || hb + 2 > MAX_BOX_DIM || (wb * hb) % 16 != 0 ||
      wb * hb > MAX_ROWS || stages < 2 || stages > MAX_STAGES ||
      smem_bytes(wb, hb, stages) > SMEM_LIMIT || splits <= 0 || splits > 65535 ||
      per_split <= 0 ||
      ((uintptr_t)x | (uintptr_t)g | (uintptr_t)ws | (uintptr_t)dw) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nwb = (W + wb - 1) / wb, nhb = (H + hb - 1) / hb;
  const long long boxes = (long long)B * nhb * nwb;
  if (boxes > 0x7fffffffLL || (long long)per_split * splits < boxes ||
      (long long)per_split * (splits - 1) >= boxes)
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (ci + BOX_CHANNELS - 1) / BOX_CHANNELS;
  const int tiles_n = (co + BOX_CHANNELS - 1) / BOX_CHANNELS;
  Plan p{(float*)ws, ci, co, tiles_n, wb, hb, nwb, nhb, wb * hb, x_box_bytes(wb, hb),
         (int)boxes, per_split, stages};
  CUtensorMap tx, tg;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  if (!encode_map(&tx, x, B, H, W, ci, wb, hb + 2) || !encode_map(&tg, g, B, H, W, co, wb, hb))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(wb, hb, stages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  conv3x3_wgrad_kernel<<<dim3(tiles_m * tiles_n, splits), THREADS, smem, s>>>(tx, tg, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = 9LL * ci * co / 4;  // ci % 8 == 0
  conv3x3_wgrad_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)ws, (float4*)dw, splits, n4);
  return (int)cudaGetLastError();
}

const char* wgrad_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
