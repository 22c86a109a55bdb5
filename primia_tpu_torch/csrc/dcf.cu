// The FSS sign kernel (K4) for Hopper: DCF key generation and both
// parties' evaluation of one comparison per element, in one pass.
//
// Bound to Python through the plain C launcher at the end (loaded with
// ctypes by primia_tpu_torch/ops/_build.py and wrapped in
// primia_tpu_torch/ops/cuda_dcf.py, which also holds the plain PyTorch
// version: mpc/dcf.py's dcf_gen_from_seeds followed by dcf_eval at both
// parties).
//
// dcf_sign_kernel
//   Replaces the TPU kernel primia_tpu/ops/pallas_dcf.py:_sign_kernel
//   (pallas_call in dcf_sign_fused). For each element i it computes
//     out[0][i] + out[1][i] == (1 - 2 c[i]) * 1{x[i] < alpha[i]}  (mod 2^64)
//   with the keys of Boyle-Gilboa-Ishai's DCF over n_bits-bit points,
//   grown from the root seeds seeds[0][i], seeds[1][i] with the
//   Threefry-2x32-20 PRG of mpc/prg.py: seed for seed, bit for bit the
//   keys and shares of dcf_gen_from_seeds + dcf_eval.
//
//   Design: one thread per element, and the walks of the tree in
//   lockstep, level by level, in registers: the key walk (both parties'
//   seeds and control bits and the v_alpha accumulator) makes the level's
//   correction words, and the evaluation consumes them at once. The
//   ~0.5 KB of correction words an element needs never touch memory,
//   which is what the TPU kernel's fusion bought; there the ring payload
//   ran in u32 limb pairs over (rows, 128) lane planes, here it is a
//   native unsigned long long, and each rotation one funnel shift.
//   The evaluation is the TPU kernel's merged form: while x follows
//   alpha's path each party's evaluation seed is its key-walk seed, so
//   the key walk's children serve it; past the first level where the
//   bits differ both parties' evaluation states are equal, and one walk
//   expanding only the child on x's path (3 blocks: the counters are
//   data, so the side moves into the counter) serves both. The key walk
//   expands both children of both seeds: 12 Threefry blocks a level,
//   plus 3 past the divergence.
//
//   Bound: integer issue, not bytes. An element reads 44 bytes (four
//   seed words per party, alpha, c, x) and writes 16, while each
//   Threefry-2x32-20 block has 20 rotations (one SHF each) and 20 xors
//   (one LOP3 each), which issue only on the SM's 64 INT32 lanes a
//   clock; its adds may also go to the FMA pipe as IMAD. The blocks of
//   one seed share the counter's second word and so their first
//   rotation: a level's key walk needs 2 x (6 x 40 - 5) INT32-lane
//   operations, the merged walk 3 x 40 - 2 more past the divergence.
//   That sets the least time. The level loop is not unrolled, so the
//   SASS of its body is one level's. The kernel keeps every operand in
//   registers and reads each input word once, coalesced.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 128;
constexpr uint32_t kParity = 0x1BD11BDAu;

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

// One Threefry-2x32-20 block: encrypts the counter (x0, x1) under (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

// Block c of seed s: counter (s[2] ^ c, s[3]) under key (s[0], s[1]).
__device__ __forceinline__ void block(const uint32_t s[4], uint32_t c, uint32_t& o0,
                                      uint32_t& o1) {
  o0 = s[2] ^ c;
  o1 = s[3];
  threefry(s[0], s[1], o0, o1);
}

// A child of G(s): its seed (control bit cleared), control bit, payload.
struct Child {
  uint32_t s[4];
  uint32_t t;
  u64 v;
};

// The child on side `side` (0 = L, 1 = R): seed words from blocks 2*side
// and 2*side + 1, payload from block 4 + side (mpc/prg.py:expand's words
// 0-3 / 4-7 and 8-9 / 10-11).
__device__ __forceinline__ Child child(const uint32_t s[4], uint32_t side) {
  Child ch;
  block(s, 2u * side, ch.s[0], ch.s[1]);
  block(s, 2u * side + 1u, ch.s[2], ch.s[3]);
  uint32_t p0, p1;
  block(s, 4u + side, p0, p1);
  ch.t = ch.s[0] & 1u;
  ch.s[0] &= ~1u;
  ch.v = (u64)p0 | ((u64)p1 << 32);
  return ch;
}

__device__ __forceinline__ u64 convert(const uint32_t s[4]) {
  return (u64)s[0] | ((u64)s[1] << 32);
}

__global__ void __launch_bounds__(kThreads)
dcf_sign_kernel(const uint4* __restrict__ seeds, const uint32_t* __restrict__ alpha,
                const uint32_t* __restrict__ csel, const uint32_t* __restrict__ xs,
                u64* __restrict__ out, long long n, int n_bits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 r0 = seeds[i];
  const uint4 r1 = seeds[n + i];
  const uint32_t al = alpha[i];
  const uint32_t xv = xs[i];
  const u64 beta = csel[i] ? ~0ull : 1ull;  // 1 - 2c

  // key walk: both parties' seeds g0, g1, control bits t0, t1, v_alpha
  uint32_t g0[4] = {r0.x, r0.y, r0.z, r0.w};
  uint32_t g1[4] = {r1.x, r1.y, r1.z, r1.w};
  uint32_t t0 = 0u, t1 = 1u;
  u64 va = 0ull;
  // the merged evaluation walk past the first level where x and alpha
  // differ (div): seed em, control bit tem; the two output shares v0, v1
  bool div = false;
  uint32_t em[4] = {r0.x, r0.y, r0.z, r0.w};
  uint32_t tem = 0u;
  u64 v0 = 0ull, v1 = 0ull;

#pragma unroll 1
  for (int lvl = 0; lvl < n_bits; ++lvl) {
    const int sh = n_bits - 1 - lvl;
    const uint32_t ab = (al >> sh) & 1u;
    const uint32_t xb = (xv >> sh) & 1u;
    const uint32_t t0p = t0, t1p = t1;  // this level's bits, before the update

    // ---- key generation (mpc/dcf.py:dcf_gen_from_seeds, one level):
    // keep the child on alpha's side, lose the other
    const Child L0 = child(g0, 0u), R0 = child(g0, 1u);
    const Child L1 = child(g1, 0u), R1 = child(g1, 1u);
    const u64 v_lose0 = ab ? L0.v : R0.v, v_lose1 = ab ? L1.v : R1.v;
    const u64 v_keep0 = ab ? R0.v : L0.v, v_keep1 = ab ? R1.v : L1.v;
    // d = v_lose1 - v_lose0 - v_alpha (+ beta where alpha_i == 1);
    // v_cw = sign_1 * d with sign_1 = (-1)^t1, and sign_1 * v_cw == d
    u64 d = v_lose1 - v_lose0 - va;
    if (ab) d += beta;
    const u64 v_cw = t1 ? 0ull - d : d;
    va = va - v_keep1 + v_keep0 + d;
    uint32_t s_cw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s_cw[k] = (ab ? L0.s[k] : R0.s[k]) ^ (ab ? L1.s[k] : R1.s[k]);
    const uint32_t t_cw_L = L0.t ^ L1.t ^ ab ^ 1u;
    const uint32_t t_cw_R = R0.t ^ R1.t ^ ab;
    const uint32_t t_cw_keep = ab ? t_cw_R : t_cw_L;
    const uint32_t m0 = 0u - t0, m1 = 0u - t1;  // all ones where t == 1
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g0[k] = (ab ? R0.s[k] : L0.s[k]) ^ (s_cw[k] & m0);
      g1[k] = (ab ? R1.s[k] : L1.s[k]) ^ (s_cw[k] & m1);
    }
    t0 = (ab ? R0.t : L0.t) ^ (t0 & t_cw_keep);
    t1 = (ab ? R1.t : L1.t) ^ (t1 & t_cw_keep);

    // ---- evaluation at x, both parties (mpc/dcf.py:dcf_eval, one level)
    const uint32_t t_cw_x = xb ? t_cw_R : t_cw_L;
    u64 h0, h1;
    if (div) {
      // past the divergence both parties hold the same seed and control
      // bit (the correction s_cw = s_lose0 ^ s_lose1 maps either party's
      // lose-side child onto the other's, and t0 ^ t1 == 1 on the way
      // there), so one walk serves both, and its shares cancel
      const Child M = child(em, xb);
      h0 = h1 = M.v + (tem ? v_cw : 0ull);
      const uint32_t nm = 0u - tem;
#pragma unroll
      for (int k = 0; k < 4; ++k) em[k] = M.s[k] ^ (s_cw[k] & nm);
      tem = M.t ^ (tem & t_cw_x);
    } else {
      // on the common prefix of x and alpha each party's evaluation seed
      // is its key-walk seed: reuse the key walk's children on x's side
      h0 = (xb ? R0.v : L0.v) + (t0p ? v_cw : 0ull);
      h1 = (xb ? R1.v : L1.v) + (t1p ? v_cw : 0ull);
      // party 0's corrected child on x's side; it is where the merged
      // walk starts if x leaves alpha's path at this level, else unused
#pragma unroll
      for (int k = 0; k < 4; ++k) em[k] = t0p ? (xb ? R1.s[k] : L1.s[k]) : (xb ? R0.s[k] : L0.s[k]);
      tem = (xb ? R0.t : L0.t) ^ (t0p & t_cw_x);
      div = xb != ab;
    }
    v0 += h0;
    v1 -= h1;
  }

  // last_cw = sign_1 * (convert(g1) - convert(g0) - v_alpha); where x
  // never left alpha's path, each party's evaluation state is its key state
  const u64 dl = convert(g1) - convert(g0) - va;
  const u64 last = t1 ? 0ull - dl : dl;
  if (div) {
    const u64 fm = convert(em) + (tem ? last : 0ull);
    v0 += fm;
    v1 -= fm;
  } else {
    v0 += convert(g0) + (t0 ? last : 0ull);
    v1 -= convert(g1) + (t1 ? last : 0ull);
  }
  out[i] = v0;
  out[n + i] = v1;
}

}  // namespace

extern "C" {

// seeds: (2, n, 4) 32-bit words, 16-byte aligned; alpha, c, x: (n,)
// 32-bit words (c is 0 or 1); out: (2, n) int64. Returns cudaGetLastError().
int dcf_sign(const void* seeds, const void* alpha, const void* c, const void* x, void* out,
             long long n, int n_bits, void* stream) {
  if (n <= 0 || n_bits < 1 || n_bits > 32) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  dcf_sign_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)seeds, (const uint32_t*)alpha, (const uint32_t*)c, (const uint32_t*)x,
      (u64*)out, n, n_bits);
  return (int)cudaGetLastError();
}

const char* dcf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
