// X1 x1_build_tables: decompress pubkeys and expand their 16-entry Niels
// tables for the pubkey arena. Replaces the XLA program the reference
// builds the arena with (cometbft_tpu/ops/verify.py _builder_kernel ->
// curve.build_pubkey_tables), whose (16, 4, 20, M) arena it writes limb for
// limb: K2 and K4 read it as the reference's kernels read theirs.
//
// What bounds it: one lane's serial chain, as one warp issues it, more
// than the card's throughput (35,288 multiply-adds a lane at the bound's
// pricing, ops/cuda_verify.MULADDS_PER_LANE, and 5,205 B, the table
// written once). A's decompression is 273 dependent field operations (the
// sqrt chain), a squaring 197 instructions of which 74 are IMAD.WIDE.U32,
// issued one every ~6.3 clocks a warp on an H100; the table is 30 rounds
// of 13-bit products. On an H100 SXM (700 W) a block spends ~207 k cycles
// decompressing and ~111 k building, whatever the lane count
// (kernel_ab.py --probe x1_phases). chip_smoke.x1_lane_ms prices the
// chain from this kernel's SASS.
//
// Design. The decompressed point's limbs depend only on the canonical x,
// y's input limbs and the sign (curve.decompress: x = the parity flip of
// canonical(x) in 13-bit limbs, T = x * y), not on the radix the sqrt chain
// runs in. So the chain runs on fe26.cuh (decompress_xc: a product is 100
// 64-bit multiply-adds, where the 13-bit radix needs 400), one thread a
// lane in the block's first warp; the canonical x splits exactly into
// 13-bit limbs, and the flip and everything after run on ed25519.cuh's
// 13-bit ops. The table is built by a quad of threads a lane, op for op as
// curve._build_a_table: each round of independent products in the
// reference (point_double's four squarings, then four products;
// affine_niels_add's three products, then four; to_niels's one) is spread
// over the quad's four threads, thread c holding coordinate c of the
// current point (X, Y, Z, T), and the operands move by __shfl_sync inside
// the quad. No op is merged or reordered: a reordered sum gives other lazy
// limbs. To fill round a's fourth slot, to_niels's 2dT of entry k - 1 is
// multiplied beside the first products of the add that makes entry k,
// which share its Y+X, Y-X and 2Z. A's doubling, 13 affine adds and the
// last to_niels take 30 rounds of products a lane.
//
// Blocks of four warps, 32 lanes: warp 0 decompresses the block's lanes
// into shared memory, then all four warps build their tables (one lane a
// quad), so no warp issues a decompression for fewer than 32 lanes and the
// table's work spreads over 4 x as many warps. Thread c writes plane
// (Y-X, Y+X, 2Z, 2dT)[c] of each entry: a warp's store covers 8 lanes of 4
// rows, 32 B each. Lanes past N run on lane N - 1 and store nothing, since
// a thread that returned would break its quad's shuffles. d and sqrt(-1)
// (paired) and 2d are staged in shared memory once a block.
#include <cuda_runtime.h>

#include "ed25519.cuh"
#include "fe26.cuh"

constexpr int WARPS = 4;
constexpr int BLOCK = 32 * WARPS;
constexpr int LANES = BLOCK / 4;  // lanes a block

namespace {

// shared constants: d and sqrt(-1) paired, then 2d in 13-bit limbs
constexpr int S_D = 0;
constexpr int S_SQRTM1 = f26::NL;
constexpr int N_S26 = 2 * f26::NL;

// Round a of P + A (curve.affine_niels_add, A's affine-Niels form in m:
// (y-x, y+x, 2dxy, 2d)[c]), with to_niels of P beside it. Thread 0 makes
// Y-X times A's y-x (a), thread 1 Y+X times y+x (b), thread 2 T times 2dxy
// (c) and 2Z (d), thread 3 T times 2d. Returns thread c's component of P
// in projective-Niels form: Y-X, Y+X, 2Z, 2dT.
__device__ __forceinline__ ed::fe round_a(const ed::fe& p, const ed::fe& m,
                                          int c, ed::fe& r, ed::fe& dz) {
  const ed::fe s1 = ed::fe_shfl(p, c < 2 ? 1 : 3);  // Y, Y, T, T
  const ed::fe s2 = ed::fe_shfl(p, c < 2 ? 0 : 2);  // X, X, Z, Z
  const ed::fe yx = ed::fe_add_sub(s1, s2, c == 0);
  dz = ed::fe_dbl2(s2);
  r = ed::fe_mul(ed::fe_select(c < 2, yx, s1), m);
  return ed::fe_select(c < 2, yx, ed::fe_select(c == 2, dz, r));
}

// Between the add's rounds: from round a's a, b, c (r of threads 0-2) and
// d (dz of thread 2), thread 0 makes e = b - a, thread 1 h = b + a,
// thread 2 f = d - c and thread 3 g = d + c.
__device__ __forceinline__ ed::fe add_efhg(const ed::fe& r, const ed::fe& dz,
                                          int c) {
  const ed::fe q = ed::fe_shfl(r, c == 0 ? 1 : (c == 1 ? 0 : 2));  // b a c c
  const ed::fe d = ed::fe_shfl(dz, 2);
  const ed::fe lhs = ed::fe_select(c == 0, q, ed::fe_select(c == 1, r, d));
  const ed::fe rhs = ed::fe_select(c == 0 || c == 2, r, q);
  return ed::fe_add_sub(lhs, rhs, c == 0 || c == 2);
}

// The last round of a doubling or an add: from e, h, f, g in threads 0-3,
// thread c makes coordinate c of (X, Y, Z, T) = (e f, g h, f g, e h).
__device__ __forceinline__ ed::fe round_b(const ed::fe& w, int c) {
  const ed::fe u = ed::fe_shfl(w, c == 1 ? 3 : (c == 3 ? 0 : c));  // e g f e
  const ed::fe v = ed::fe_shfl(w, c == 0 ? 2 : (c == 2 ? 3 : 1));  // f h g h
  return ed::fe_mul(u, v);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(BLOCK, 3)
    x1_build_tables(const int32_t* __restrict__ y_a,
                    const int32_t* __restrict__ sign_a,
                    const int32_t* __restrict__ consts,
                    int32_t* __restrict__ table, uint8_t* __restrict__ ok,
                    int n) {
  __shared__ uint32_t s26[N_S26];
  __shared__ int32_t s2d[ed::NL];
  __shared__ int32_t xs[ed::NL * LANES];  // the lanes' x, 13-bit limbs
  const int t = threadIdx.x;
  for (int k = t; k < N_S26 + ed::NL; k += BLOCK) {
    if (k < N_S26) {  // kernel_consts is 13-bit: pair words 2w and 2w + 1
      const int w = k < S_SQRTM1 ? f26::C_D + k : f26::C_SQRTM1 + k - S_SQRTM1;
      s26[k] = (uint32_t)consts[2 * w] + ((uint32_t)consts[2 * w + 1] << 13);
    } else {
      s2d[k - N_S26] = consts[2 * f26::C_D2 + k - N_S26];
    }
  }
  __syncthreads();
  const size_t base = (size_t)blockIdx.x * LANES;

  // A's decompression, one thread a lane: the canonical x from the sqrt
  // chain in 26-bit limbs, split into 13-bit ones, then the sign's flip
  if (t < LANES) {
    const size_t lane = base + t;
    const size_t ln = lane < (size_t)n ? lane : (size_t)n - 1;
    f26::fe xc;
    const bool dec = f26::decompress_xc(xc, f26::fe_load13(y_a + ln, n),
                                        s26 + S_D, s26 + S_SQRTM1);
    ed::fe x;
#pragma unroll
    for (int i = 0; i < f26::NL; ++i) {
      x.v[2 * i] = (int32_t)(xc.v[i] & ed::MASK);
      x.v[2 * i + 1] = (int32_t)(xc.v[i] >> ed::BITS);
    }
    if ((x.v[0] & 1) != sign_a[ln]) x = ed::fe_neg(x);
#pragma unroll
    for (int i = 0; i < ed::NL; ++i) xs[i * LANES + t] = x.v[i];
    if (lane < (size_t)n) ok[lane] = dec ? 1 : 0;
  }
  __syncthreads();

  // the table, one lane a quad
  const int c = t & 3;
  const int q = t >> 2;
  const size_t lane = base + q;
  const bool live = lane < (size_t)n;
  const size_t ln = live ? lane : (size_t)n - 1;
  ed::fe x, d2;
#pragma unroll
  for (int i = 0; i < ed::NL; ++i) {
    x.v[i] = xs[i * LANES + q];
    d2.v[i] = s2d[i];
  }
  const ed::fe y = ed::fe_load(y_a + ln, n);
  // thread c's plane of entry e: row (e * 4 + plane) * 20 + limb
  int32_t* const col =
      table + (size_t)(c < 2 ? c ^ 1 : c) * ed::NL * n + ln;
  const size_t entry = (size_t)4 * ed::NL * n;
  auto store = [&](int e, const ed::fe& v) {
    if (live) ed::fe_store(col + e * entry, n, v);
  };
  store(0, ed::fe_small(c == 2 ? 2 : (c < 2 ? 1 : 0)));  // (1, 1, 2, 0)

  // A = (x, y, 1, xy) and [2]A (curve.point_double). Round 1: x^2, y^2,
  // the T = x y of curve.decompress and (x+y)^2; a squaring is fe_mul(a, a)
  const ed::fe one = ed::fe_small(1);
  const ed::fe xy = ed::fe_add(x, y);
  const ed::fe r0 = ed::fe_mul(
      ed::fe_select(c == 1, y, ed::fe_select(c == 3, xy, x)),
      ed::fe_select(c == 0, x, ed::fe_select(c == 3, xy, y)));
  // round 2: Z^2 = 1 * 1 in thread 2, 2dT elsewhere (entry 1's and A's
  // affine-Niels 2dxy, curve.to_niels and to_affine_niels)
  const ed::fe ta = ed::fe_shfl(r0, 2);
  const ed::fe r1 = ed::fe_mul(ed::fe_select(c == 2, one, ta),
                               ed::fe_select(c == 2, one, d2));
  const ed::fe yx = ed::fe_add_sub(y, x, c == 0);  // y-x, y+x
  store(1, ed::fe_select(c < 2, yx, ed::fe_select(c == 2, ed::fe_dbl2(one),
                                                    r1)));
  const ed::fe m =
      ed::fe_select(c < 2, yx, ed::fe_select(c == 2, ed::fe_shfl(r1, 3), d2));
  // the doubling's middle: h = a + b (threads 0, 1), g = a - b (2, 3), then
  // e = h - (x+y)^2 in thread 0 and f = 2 Z^2 + g in thread 2
  const ed::fe a2 = ed::fe_shfl(r0, 0);
  const ed::fe b2 = ed::fe_shfl(r0, 1);
  const ed::fe s4 = ed::fe_shfl(r0, 3);
  const ed::fe u = ed::fe_add_sub(a2, b2, c >= 2);
  const ed::fe cz = ed::fe_dbl2(r1);
  const ed::fe w = ed::fe_add_sub(ed::fe_select(c == 0, u, cz),
                                  ed::fe_select(c == 0, s4, u), c == 0);
  ed::fe p = round_b(ed::fe_select(c == 0 || c == 2, w, u), c);

  // entries 2-14 in Niels form, each beside the add that makes the next
#pragma unroll 1
  for (int e = 2; e < 15; ++e) {
    ed::fe r, dz;
    store(e, round_a(p, m, c, r, dz));
    p = round_b(add_efhg(r, dz, c), c);
  }
  ed::fe r, dz;
  store(15, round_a(p, m, c, r, dz));
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_build_tables(const int32_t* y_a, const int32_t* sign_a,
                                    const int32_t* consts, int32_t* table,
                                    uint8_t* ok, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  x1_build_tables<<<(n + LANES - 1) / LANES, BLOCK, 0, stream>>>(
      y_a, sign_a, consts, table, ok, n);
  return (int)cudaGetLastError();
}
