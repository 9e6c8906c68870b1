// GF(2^255 - 19) in a Hopper radix, and edwards25519 point code run by a
// quad of threads per signature lane, for the four verify kernels: K1
// (verify_uncached.cu), K2 (verify_cached.cu), K3 (verify8_uncached.cu)
// and K4 (verify8_cached.cu). The arena builder X1 (build_tables.cu) runs
// its decompression here too (decompress_xc), up to the canonical x, and
// builds the table on the reference's 13-bit limbs (ed25519.cuh), whose
// arena it writes bit for bit.
//
// ------------------------------------------------------------- the field
// A field element is 10 limbs of 26 bits in uint32, value = sum v[i] <<
// (26 i). Each limb is a pair of the 13-bit limbs of ed25519.cuh and of
// the arena, y_r, the B table and tab8: v[i] = l[2i] + (l[2i+1] << 13), one
// shift-add a limb, no ripple. A product is 100 multiply-adds of 32 x 32
// -> 64 bits (IMAD.WIDE.U32) into 19 uint64 columns, where the 13-bit
// radix needs 400 int32 multiply-adds into 39 columns.
//
// Interval proof (tests/test_torch_fe26.py replays every step on Python
// ints and asserts each bound). The invariant: every op takes limbs <=
// LAZY = 2^26 + 2^24 = 83,886,080 and returns limbs <= LAZY. A paired
// lazy 13-bit limb is at most 10015 + 10015 * 2^13 = 82,052,895 <= LAZY,
// so arena rows load as they are.
// * mul/sq: a column holds at most 10 products of <= LAZY^2, so
//   c[k] <= 10 * LAZY^2 = 70,368,744,177,664,000 < 2^56. The nine high
//   columns (weight 2^(260 + 26 i), 2^260 == 608 mod p) split into lo26
//   and hi before the fold factor multiplies them: lo26 * 608 < 2^36 goes
//   to column i, hi * 608 < 2^40 to column i + 1. The largest post-fold
//   column is t[9] <= 70,368,807,931,084,800 < 2^56.
//   Pass 1 (64-bit): limb i >= 1 becomes lo26(t[i]) + (t[i-1] >> 26) <
//   2^26 + 2^30 < 2^31; limb 0 becomes lo26(t[0]) + (t[9] >> 26) * 608 <
//   2^40 and stays 64-bit. Pass 2: limb 1 gets at most 9,501 and limb 0 at
//   most 15 * 608, so every limb ends <= 2^26 + 9,500 < LAZY.
// * add: a + b <= 2 LAZY < 2^28; one carry pass ends <= 2^26 + 2 * 608.
// * sub/neg: a + BIAS - b with BIAS = 4 (2^260 - 1) - 2428 == 0 mod p,
//   every limb >= 2^28 - 2432 > LAZY, so no limb goes negative, and
//   a + BIAS < 2^29; one carry pass ends <= 2^26 + 7 * 608.
// * canonical: two ripple rounds with 2^255 -> 19 folding leave a value
//   < 2^255 in canonical limbs (the second round's top carry is 1 only if
//   limbs 1-9 were all full, and then limb 0 is < 760 before + 19), then
//   one conditional subtract of p. Exact for every value below 2^260 with
//   limbs <= LAZY, so for y in [p, 2^255) as ZIP-215 admits it.
//
// The values differ limb for limb from ed25519.cuh's (another radix), so
// the kernels are held against the plain versions on their verdicts.
//
// -------------------------------------------------------------- the quad
// Four adjacent threads own one lane; thread c = threadIdx.x & 3 holds
// coordinate c of every extended point (X, Y, Z, T). Each point operation
// runs as the four-way parallel formulas of Hisil, Wong, Carter and
// Dawson, "Twisted Edwards Curves Revisited" (ASIACRYPT 2008), in the
// arrangement of curve25519-dalek's vector backend:
// * a doubling is one round of four squarings (X^2, Y^2, Z^2, (X+Y)^2)
//   and one round of four multiplications;
// * a projective-Niels add is two rounds of four multiplications; thread c
//   multiplies by one component of the cached point, (Y-X) by Y2-X2,
//   (Y+X) by Y2+X2, Z by 2Z2, T by 2dT2, so it reads one plane of a table;
// * an affine-Niels add is the same with 2 in place of 2Z2.
// Operands move between rounds with __shfl_sync inside the quad, one
// shuffle a limb; a field element stays whole in one thread, so no carry
// crosses threads. Every thread of a quad runs the same instructions:
// what differs by c is a select, never a branch, and all 32 threads of a
// warp reach every shuffle.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace f26 {

constexpr int NL = 10;
constexpr int BITS = 26;
constexpr uint32_t MASK = (1u << BITS) - 1;
constexpr uint32_t FOLD = 608;  // 2^260 == 19 * 2^5 (mod p)
constexpr uint32_t TOP_MASK = (1u << 21) - 1;  // limb 9 holds bits 234..254

// Constants staged in shared memory, paired from ops/curve.kernel_consts:
// the base-point table [16][3][10] in affine-Niels form, then d, 2d and
// sqrt(-1).
constexpr int TSIZE = 16;
constexpr int C_BTAB = 0;
constexpr int C_D = TSIZE * 3 * NL;
constexpr int C_D2 = C_D + NL;
constexpr int C_SQRTM1 = C_D2 + NL;
constexpr int N_CONSTS = C_SQRTM1 + NL;

// The paired fixed-base table of the 8-bit kernels
// (ops/cuda_verify._base_table8_26): entry (j, v) is [v 2^(8j)]B as
// (y+x, y-x, 2dxy) in 26-bit limbs and two words of padding.
constexpr int WINDOWS8 = 32;
constexpr int ENTRY8 = 32;  // int32 an entry, 128 B aligned

// A's table in the shared memory of a one-warp block: entries 1-15, one
// plane a thread (q_decompress_ar).
constexpr int ATAB_WORDS = (TSIZE - 1) * NL * 32;

struct fe {
  uint32_t v[NL];
};

// 4 (2^260 - 1) - 2428: == 0 mod p, every limb > LAZY.
__device__ __forceinline__ uint32_t bias(int i) {
  return i == 0 ? (1u << 28) - 4 - 2428 : (1u << 28) - 4;
}

// p = [2^26 - 19, 2^26 - 1 x 8, 2^21 - 1].
__device__ __forceinline__ int32_t p_limb(int i) {
  return i == 0 ? (1 << 26) - 19 : (i == NL - 1 ? (1 << 21) - 1 : (1 << 26) - 1);
}

__device__ __forceinline__ void carry1(fe& x) {
  uint32_t hi[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    hi[i] = x.v[i] >> BITS;
    x.v[i] &= MASK;
  }
  x.v[0] += hi[NL - 1] * FOLD;
#pragma unroll
  for (int i = 1; i < NL; ++i) x.v[i] += hi[i - 1];
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + b.v[i];
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + bias(i) - b.v[i];
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = bias(i) - a.v[i];
  carry1(r);
  return r;
}

// 19 columns -> 10 limbs: fold the high columns (lo26 and hi apart), then
// a 64-bit carry pass and a 32-bit one.
__device__ __forceinline__ fe fold_cols(const uint64_t (&c)[2 * NL - 1]) {
  uint64_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = c[i];
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    t[i] += (uint64_t)((uint32_t)c[NL + i] & MASK) * FOLD;
    t[i + 1] += (c[NL + i] >> BITS) * FOLD;
  }
  uint32_t r[NL];
#pragma unroll
  for (int i = 1; i < NL; ++i)
    r[i] = ((uint32_t)t[i] & MASK) + (uint32_t)(t[i - 1] >> BITS);
  const uint64_t r0 = ((uint32_t)t[0] & MASK) + (t[NL - 1] >> BITS) * FOLD;
  fe o;
  o.v[0] = ((uint32_t)r0 & MASK) + (r[NL - 1] >> BITS) * FOLD;
  o.v[1] = (r[1] & MASK) + (uint32_t)(r0 >> BITS);
#pragma unroll
  for (int i = 2; i < NL; ++i) o.v[i] = (r[i] & MASK) + (r[i - 1] >> BITS);
  return o;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint64_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += (uint64_t)a.v[i] * b.v[j];
  }
  return fold_cols(c);
}

// The columns of fe_mul(a, a) from 55 products: the cross terms once,
// against the doubled limb (2 LAZY < 2^28 fits uint32), and the diagonal.
__device__ __forceinline__ fe fe_sq(const fe& a) {
  uint64_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    c[2 * i] += (uint64_t)a.v[i] * a.v[i];
    const uint32_t d = a.v[i] << 1;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += (uint64_t)d * a.v[j];
  }
  return fold_cols(c);
}

__device__ __forceinline__ fe fe_sq_n(fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

// Unique representative in [0, p): two ripple rounds with 2^255 -> 19
// folding, then one conditional subtract of p (signed borrow chain).
__device__ __forceinline__ fe fe_canonical(fe x) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) {
      const uint32_t v = x.v[i] + c;
      x.v[i] = v & MASK;
      c = v >> BITS;
    }
    const uint32_t v = x.v[NL - 1] + c;
    x.v[NL - 1] = v & TOP_MASK;
    x.v[0] += (v >> 21) * 19;
  }
  fe y;
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t v = (int32_t)x.v[i] - p_limb(i) + borrow;
    y.v[i] = (uint32_t)v & (i < NL - 1 ? MASK : TOP_MASK);
    borrow = v >> (i < NL - 1 ? BITS : 21);  // arithmetic: 0 or -1
  }
  return borrow == 0 ? y : x;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  const fe c = fe_canonical(a);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= c.v[i];
  return any == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  return fe_is_zero(fe_sub(a, b));
}

// z ** (2^252 - 3), the curve25519 addition chain (field.pow_2_252_m3).
__device__ __forceinline__ fe fe_pow22523(const fe& z) {
  fe z2 = fe_sq(z);
  fe z8 = fe_sq_n(z2, 2);
  fe z9 = fe_mul(z, z8);
  fe z11 = fe_mul(z2, z9);
  fe z22 = fe_sq(z11);
  fe z_5_0 = fe_mul(z9, z22);
  fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);
  fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);
  fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);
  fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);
  fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);
  fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);
  fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);
  return fe_mul(fe_sq_n(z_250_0, 2), z);
}

__device__ __forceinline__ fe fe_small(uint32_t v0) {
  fe r{};
  r.v[0] = v0;
  return r;
}

__device__ __forceinline__ fe fe_select(bool take_a, const fe& a,
                                        const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = take_a ? a.v[i] : b.v[i];
  return r;
}

// Paired limbs of a 26-bit constant array (shared memory).
__device__ __forceinline__ fe fe_const(const uint32_t* s) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = s[i];
  return r;
}

// A 13-bit-limb element of a lane-minor array (limb l at p[l * stride]),
// paired on load.
__device__ __forceinline__ fe fe_load13(const int32_t* p, size_t stride) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = (uint32_t)p[(size_t)(2 * i) * stride] +
             ((uint32_t)p[(size_t)(2 * i + 1) * stride] << 13);
  return r;
}

// kernel_consts (13-bit limbs, each element's 20 limbs contiguous) into
// shared memory as 26-bit limbs: word k pairs words 2k and 2k + 1.
__device__ __forceinline__ void stage_consts26(uint32_t* sm,
                                               const int32_t* consts) {
  for (int k = threadIdx.x; k < N_CONSTS; k += blockDim.x)
    sm[k] = (uint32_t)consts[2 * k] + ((uint32_t)consts[2 * k + 1] << 13);
  __syncthreads();
}

// ZIP-215 decompression (curve.decompress) of y (limbs <= LAZY; y >= p and
// "negative zero" are accepted) up to the canonical x, before the sign
// bit's parity is applied, and whether y decodes. d and sqrt(-1) are
// paired constants (shared memory).
__device__ __forceinline__ bool decompress_xc(fe& xc_out, const fe& y,
                                              const uint32_t* d,
                                              const uint32_t* sqrtm1) {
  const fe one = fe_small(1);
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, one);
  const fe v = fe_add(fe_mul(fe_const(d), yy), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  const fe vxx = fe_mul(v, fe_sq(x));
  const bool root_ok = fe_eq(vxx, u);
  const bool flip_ok = fe_eq(vxx, fe_neg(u));
  x = fe_select(flip_ok, fe_mul(x, fe_const(sqrtm1)), x);
  xc_out = fe_canonical(x);
  return root_ok || flip_ok;
}

// decompress_xc, then x with the sign bit's parity. Every thread of a quad
// runs it on the same inputs.
__device__ __forceinline__ bool decompress_x(fe& x_out, const fe& y,
                                             int32_t sign,
                                             const uint32_t* sm) {
  fe xc;
  const bool ok = decompress_xc(xc, y, sm + C_D, sm + C_SQRTM1);
  x_out = fe_select((int32_t)(xc.v[0] & 1) != sign, fe_neg(xc), xc);
  return ok;
}

// ------------------------------------------------------------ quad ops

__device__ __forceinline__ int quad_c() { return threadIdx.x & 3; }

// Element of thread `src` (0-3) of this quad.
__device__ __forceinline__ fe fe_shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, 4);
  return r;
}

__device__ __forceinline__ fe fe_shfl_xor1(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], 1, 4);
  return r;
}

// Coordinate c of the identity (0, 1, 1, 0).
__device__ __forceinline__ fe q_identity(int c) {
  return fe_small(c == 1 || c == 2 ? 1 : 0);
}

// [2]P. Round 1: thread c squares (X, Y, Z, X+Y)[c] into S1..S4. Then
// (S5, S6, S8, S9) = (S1+S2, S1-S2, S1-S2+2S3, S1+S2-S4) in threads 0-3,
// and round 2 gives (X', Y', Z', T') = (S8 S9, S5 S6, S8 S6, S5 S9).
__device__ __forceinline__ fe q_double(const fe& p, int c) {
  const fe x = fe_shfl(p, 0);
  const fe y = fe_shfl(p, 1);
  const fe s = fe_sq(fe_select(c == 3, fe_add(x, y), p));
  const fe s1 = fe_shfl(s, 0);
  const fe s2 = fe_shfl(s, 1);
  const bool minus_s2 = c == 1 || c == 2;
  fe w;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t b = bias(i);
    uint32_t t = s1.v[i] + (minus_s2 ? b - s2.v[i] : s2.v[i]);
    t += c == 2 ? s.v[i] << 1 : 0;
    t += c == 3 ? b - s.v[i] : 0;
    w.v[i] = t;
  }
  carry1(w);
  const fe u = fe_shfl(w, (c & 1) ? 0 : 2);
  const fe v = fe_shfl(w, (c == 0 || c == 3) ? 3 : 1);
  return fe_mul(u, v);
}

// P + Q with Q in Niels form, thread c holding n = (Y2-X2, Y2+X2, 2Z2,
// 2dT2)[c] (2 for an affine Q). Round 1: (Y-X, Y+X, Z, T)[c] * n gives
// (A, B, D, C); then (E, H, F, G) = (B-A, B+A, D-C, D+C), and round 2
// gives (X', Y', Z', T') = (E F, G H, F G, E H).
__device__ __forceinline__ fe q_add(const fe& p, const fe& n, int c) {
  const fe q = fe_shfl_xor1(p);
  fe w;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t b = bias(i);
    w.v[i] = c == 0 ? q.v[i] + b - p.v[i]
                    : (c == 1 ? p.v[i] + q.v[i] : p.v[i]);
  }
  carry1(w);
  const fe r = fe_mul(w, n);
  const fe o = fe_shfl_xor1(r);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t b = bias(i);
    w.v[i] = c == 0 ? o.v[i] + b - r.v[i]
                    : (c == 2 ? r.v[i] + b - o.v[i] : r.v[i] + o.v[i]);
  }
  carry1(w);
  const fe u = fe_shfl(w, c == 1 ? 3 : (c == 3 ? 0 : c));
  const fe v = fe_shfl(w, c == 0 ? 2 : (c == 2 ? 3 : 1));
  return fe_mul(u, v);
}

// Thread c's Niels component (Y-X, Y+X, 2Z, 2dT)[c] of the extended point
// whose coordinate c it holds: one round, a multiplication by 2d in
// thread 3 and by 1 elsewhere.
__device__ __forceinline__ fe q_to_niels(const fe& p, const fe& d2, int c) {
  const fe q = fe_shfl_xor1(p);
  fe w;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t b = bias(i);
    w.v[i] = c == 0 ? q.v[i] + b - p.v[i]
                    : (c == 3 ? p.v[i] : p.v[i] + (c == 1 ? q.v[i] : p.v[i]));
  }
  carry1(w);
  return fe_mul(w, fe_select(c == 3, d2, fe_small(1)));
}

// Thread c's component (y-x, y+x, 2, 2dxy)[c] of the affine point (x, y)
// in affine-Niels form: what q_add takes for an affine Q.
__device__ __forceinline__ fe q_affine_niels(const fe& x, const fe& y,
                                             const fe& d2, int c) {
  const fe m = fe_mul(fe_mul(x, y), d2);
  const fe s = fe_select(c == 0, fe_sub(y, x), fe_add(y, x));
  return fe_select(c < 2, s, fe_select(c == 2, fe_small(2), m));
}

// Thread c's component of -R in affine-Niels form, (y+x, y-x, 2, -2dxy)[c]
// (the Niels form of (-x, y, 1, -xy)), from R's affine x, y.
__device__ __forceinline__ fe q_neg_affine(const fe& x, const fe& y,
                                           const fe& d2, int c) {
  return q_affine_niels(fe_neg(x), y, d2, c);
}

// [8](P - R) == O from P (thread c holding coordinate c) and R's negated
// affine-Niels component: the identity test X == 0 and Y == Z, which
// every thread of the quad computes on the same values.
__device__ __forceinline__ bool q_minus_r_is_small(fe acc, const fe& nr,
                                                   int c) {
  acc = q_add(acc, nr, c);
#pragma unroll 1
  for (int d = 0; d < 3; ++d) acc = q_double(acc, c);
  const fe x = fe_shfl(acc, 0);
  const fe y = fe_shfl(acc, 1);
  const fe z = fe_shfl(acc, 2);
  return fe_is_zero(x) && fe_is_zero(fe_sub(y, z));
}

// --------------------------------------------------- the 8-bit flavor

// [S]B (curve.fixed_base_sum8): 32 affine adds from the identity over the
// paired fixed-base table; a byte is read modulo 256. Thread c reads its
// plane (y-x, y+x, 2dxy)[c] of an entry, 40 B in five 8-byte loads
// (thread 2 multiplies by 2 and reads nothing it uses). The whole table
// (1 MB) stays in L2.
__device__ __forceinline__ fe q_fixed_base8(const int32_t* __restrict__ tab8,
                                            const int32_t* s_bytes, int n,
                                            size_t ln, int c) {
  const int tplane = c == 0 ? 1 : (c == 1 ? 0 : 2);
  fe sb = q_identity(c);
#pragma unroll 1
  for (int j = 0; j < WINDOWS8; ++j) {
    const int v = s_bytes[(size_t)j * n + ln] & 255;
    const int2* e = reinterpret_cast<const int2*>(
        tab8 + ((size_t)j * 256 + v) * ENTRY8 + tplane * NL);
    fe nb;
#pragma unroll
    for (int i = 0; i < NL / 2; ++i) {
      const int2 w = __ldg(e + i);
      nb.v[2 * i] = (uint32_t)w.x;
      nb.v[2 * i + 1] = (uint32_t)w.y;
    }
    sb = q_add(sb, fe_select(c == 2, fe_small(2), nb), c);
  }
  return sb;
}

// ------------------------------------------- A's table (K1 and K3 only)
// [O, A, 2A, ..., 15A] in projective-Niels form, built by the quad into
// shared memory: thread c keeps its own plane (Y-X, Y+X, 2Z, 2dT)[c] of
// entries 1-15, which is the operand q_add takes from it in the ladder.
// Thread t's element (entry e, limb i) sits at [((e - 1) NL + i) 32 + t],
// so a warp's 32 accesses hit 32 banks, and a thread reads only what it
// wrote: no barrier. Entry 0, the identity (1, 1, 2, 0), is selected, not
// stored.

__device__ __forceinline__ void atab_store(uint32_t* tab, int e,
                                           const fe& v) {
  uint32_t* p = tab + (e - 1) * NL * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i * 32] = v.v[i];
}

__device__ __forceinline__ fe atab_load(const uint32_t* tab, int e, int c) {
  const uint32_t* p = tab + (e > 0 ? e - 1 : 0) * NL * 32 + (threadIdx.x & 31);
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = p[i * 32];
  return fe_select(e == 0, fe_small(c == 2 ? 2 : (c < 2 ? 1 : 0)), r);
}

// A and R decompressed side by side, threads 0-1 on A and threads 2-3 on
// R (one decompression a thread's chain; the inputs are selected, so every
// thread reaches every shuffle), then A's table built by the quad in the
// order of curve._build_a_table: entry 1 is A's affine-Niels form, entry 2
// [2]A, entries 3-15 one affine add each. Returns, on all four threads,
// whether A and R both decode (A's flag from thread 0, R's from thread 2);
// nr gets thread c's component of -R (q_neg_affine).
__device__ __forceinline__ bool q_decompress_ar(
    const int32_t* y_a, const int32_t* sign_a, const int32_t* y_r,
    const int32_t* sign_r, int n, size_t ln, const uint32_t* sm,
    uint32_t* atab, fe& nr, int c) {
  const bool side_a = c < 2;
  const fe y = fe_load13((side_a ? y_a : y_r) + ln, n);
  fe x;
  const uint32_t dec =
      decompress_x(x, y, side_a ? sign_a[ln] : sign_r[ln], sm);
  const bool ok = (__shfl_sync(0xffffffffu, dec, 0, 4) &
                   __shfl_sync(0xffffffffu, dec, 2, 4)) != 0;
  const fe d2 = fe_const(sm + C_D2);
  const fe xa = fe_shfl(x, 0);
  const fe ya = fe_shfl(y, 0);
  nr = q_neg_affine(fe_shfl(x, 2), fe_shfl(y, 2), d2, c);
  const fe na = q_affine_niels(xa, ya, d2, c);
  atab_store(atab, 1, na);
  // A extended: (x, y, 1, xy)[c]
  fe cur = fe_select(c == 0, xa,
                     fe_select(c == 1, ya,
                               fe_select(c == 2, fe_small(1),
                                         fe_mul(xa, ya))));
  cur = q_double(cur, c);
  atab_store(atab, 2, q_to_niels(cur, d2, c));
#pragma unroll 1
  for (int e = 3; e < TSIZE; ++e) {
    cur = q_add(cur, na, c);
    atab_store(atab, e, q_to_niels(cur, d2, c));
  }
  return ok;
}

// ------------------------------------------------------------- the host

// Asks once per device for the largest shared-memory carveout for
// `kernel`, so that CUDA does not choose a smaller one and cap the blocks
// an SM holds. Each kernel source instantiates it for its own
// kernel.
template <class K>
inline int prefer_max_shared(K kernel) {
  static bool set[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0 || (dev < 64 && set[dev])) return err;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err == 0 && dev < 64) set[dev] = true;
  return err;
}

}  // namespace f26
