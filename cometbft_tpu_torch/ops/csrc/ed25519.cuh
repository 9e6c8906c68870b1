// GF(2^255 - 19) field and edwards25519 point code of the arena builder
// X1 (build_tables.cu), on the reference's limbs. The verify kernels K1-K4
// run on fe26.cuh instead.
//
// One thread owns one pubkey lane. A field element is 20 limbs of 13
// bits in int32 with the lazy-carry discipline of ops/field.py: every op
// takes limbs <= 10015 and returns limbs <= 10015, add/sub/neg/dbl2 carry
// once and the mul column fold three times. A schoolbook column holds at
// most 20 products of <= 10015^2 < 2^31, and a squaring's doubled cross
// column at most 2.006e9, so no int32 intermediate overflows (the interval
// proof for this representation is tests/test_field.py's). Every op here
// computes the same limbs as its counterpart in ops/field.py and
// ops/curve.py, which is what lets X1's tables be held limb for limb
// against the plain PyTorch version and the reference's arena: what is
// left here is A's decompression and its table build.
//
// Lane-minor arrays: element (row, lane) of an array with `stride` lanes
// sits at row * stride + lane, so neighbouring threads read neighbouring
// addresses.
#pragma once

#include <cstddef>
#include <cstdint>

namespace ed {

constexpr int NL = 20;
constexpr int BITS = 13;
constexpr int32_t MASK = (1 << BITS) - 1;
constexpr int32_t FOLD = 608;  // 2^260 == 19 * 2^5 (mod p)
constexpr int TSIZE = 16;

// Kernel constants (ops/curve.kernel_consts), staged in shared memory:
// the base-point table [16][3][20] in affine-Niels form, then d, 2d and
// sqrt(-1).
constexpr int C_BTAB = 0;
constexpr int C_D = TSIZE * 3 * NL;
constexpr int C_D2 = C_D + NL;
constexpr int C_SQRTM1 = C_D2 + NL;
constexpr int N_CONSTS = C_SQRTM1 + NL;

struct fe {
  int32_t v[NL];
};

// Subtraction bias: == 0 mod p, every limb >= 8191 (ops/field._SUB_BIAS).
__device__ __forceinline__ int32_t sub_bias(int i) {
  return i == 0 ? 16382 - 1214 : 16382;
}

// p in canonical limbs: [8173, 8191 x 18, 255].
__device__ __forceinline__ int32_t p_limb(int i) {
  return i == 0 ? 8173 : (i == NL - 1 ? 255 : 8191);
}

__device__ __forceinline__ void carry1(fe& x) {
  int32_t hi[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    hi[i] = x.v[i] >> BITS;  // arithmetic shift of int32
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
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + sub_bias(i) - b.v[i];
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = sub_bias(i) - a.v[i];
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_dbl2(const fe& a) { return fe_add(a, a); }

// 39 product columns -> 20 lazy limbs: high columns split into lo13/hi
// before the fold factor multiplies them, then three carry passes.
__device__ __forceinline__ fe fold_cols(const int32_t (&c)[2 * NL - 1]) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t t = c[i];
    if (i < NL - 1) t += (c[NL + i] & MASK) * FOLD;
    if (i >= 1) t += (c[NL + i - 1] >> BITS) * FOLD;
    r.v[i] = t;
  }
  carry1(r);
  carry1(r);
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  int32_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += a.v[i] * b.v[j];
  }
  return fold_cols(c);
}

// The same columns as fe_mul(a, a) from 210 products: the cross terms
// once, doubled, plus the diagonal.
__device__ __forceinline__ fe fe_sq(const fe& a) {
  int32_t c[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = i + 1; j < NL; ++j) c[i + j] += a.v[i] * a.v[j];
  }
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) c[k] += c[k];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[2 * i] += a.v[i] * a.v[i];
  return fold_cols(c);
}

__device__ __forceinline__ fe fe_sq_n(fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

// Unique representative in [0, p): two sequential ripple rounds with
// 2^255 -> 19 folding, then one conditional subtract of p whose borrow
// chain relies on the arithmetic shift of negative int32.
__device__ __forceinline__ fe fe_canonical(fe x) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int32_t c = 0;
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) {
      int32_t v = x.v[i] + c;
      x.v[i] = v & MASK;
      c = v >> BITS;
    }
    int32_t v = x.v[NL - 1] + c;
    x.v[NL - 1] = v & 0xFF;
    x.v[0] += (v >> 8) * 19;
  }
  fe y;
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t v = x.v[i] - p_limb(i) + borrow;
    y.v[i] = v & (i < NL - 1 ? MASK : 0xFF);
    borrow = v >> (i < NL - 1 ? BITS : 8);
  }
  return borrow == 0 ? y : x;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  fe c = fe_canonical(a);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) any |= c.v[i];
  return any == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  fe ca = fe_canonical(a);
  fe cb = fe_canonical(b);
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) diff |= ca.v[i] ^ cb.v[i];
  return diff == 0;
}

// z ** (2^252 - 3) by the curve25519 addition chain (field.pow_2_252_m3).
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

__device__ __forceinline__ fe fe_small(int32_t v0) {
  fe r{};
  r.v[0] = v0;
  return r;
}

__device__ __forceinline__ fe fe_const(const int32_t* s) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = s[i];
  return r;
}

__device__ __forceinline__ fe fe_load(const int32_t* p, size_t stride) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = p[(size_t)i * stride];
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* p, size_t stride,
                                         const fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[(size_t)i * stride] = a.v[i];
}

// ------------------------------------------------------------- points
// Extended (X, Y, Z, T); projective Niels (Y+X, Y-X, 2Z, 2dT); affine
// Niels (y+x, y-x, 2dxy). Complete a=-1 formulas (ops/curve.py).

struct ge {
  fe x, y, z, t;
};

struct gn {
  fe ypx, ymx, z2, t2d;
};

struct gan {
  fe ypx, ymx, t2d;
};

__device__ __forceinline__ ge ge_double(const ge& p) {
  fe a = fe_sq(p.x);
  fe b = fe_sq(p.y);
  fe c = fe_dbl2(fe_sq(p.z));
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ ge ge_add_affine(const ge& p, const gan& n) {
  fe a = fe_mul(fe_sub(p.y, p.x), n.ymx);
  fe b = fe_mul(fe_add(p.y, p.x), n.ypx);
  fe c = fe_mul(p.t, n.t2d);
  fe d = fe_dbl2(p.z);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ gn to_niels(const ge& p, const fe& d2) {
  gn r;
  r.ypx = fe_add(p.y, p.x);
  r.ymx = fe_sub(p.y, p.x);
  r.z2 = fe_dbl2(p.z);
  r.t2d = fe_mul(p.t, d2);
  return r;
}

__device__ __forceinline__ gan to_affine_niels(const ge& p, const fe& d2) {
  gan r;
  r.ypx = fe_add(p.y, p.x);
  r.ymx = fe_sub(p.y, p.x);
  r.t2d = fe_mul(p.t, d2);
  return r;
}

// ZIP-215 decompression (curve.decompress): y may be non-canonical
// (y >= p), "negative zero" is accepted. Returns whether y decodes.
__device__ __forceinline__ bool ge_decompress(ge& out, const fe& y,
                                              int32_t sign,
                                              const int32_t* sm) {
  const fe one = fe_small(1);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(fe_const(sm + C_D), yy), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  bool root_ok = fe_eq(vxx, u);
  bool flip_ok = fe_eq(vxx, fe_neg(u));
  if (flip_ok) x = fe_mul(x, fe_const(sm + C_SQRTM1));
  fe xc = fe_canonical(x);
  out.x = ((xc.v[0] & 1) != sign) ? fe_neg(xc) : xc;
  out.y = y;
  out.z = one;
  out.t = fe_mul(out.x, y);
  return root_ok || flip_ok;
}

// Table entry k of a lane-minor (16, 4, 20, stride) Niels table.
__device__ __forceinline__ void store_niels(int32_t* tab, size_t stride,
                                            size_t col, int k, const gn& n) {
  int32_t* p = tab + (size_t)k * 4 * NL * stride + col;
  fe_store(p, stride, n.ypx);
  fe_store(p + (size_t)NL * stride, stride, n.ymx);
  fe_store(p + (size_t)2 * NL * stride, stride, n.z2);
  fe_store(p + (size_t)3 * NL * stride, stride, n.t2d);
}

// [O, A, 2A, ..., 15A] in projective-Niels form into column `col` of a
// (16, 4, 20, stride) table (curve._build_a_table): one double and 13
// affine-Niels adds of the decompressed (affine) A.
__device__ __forceinline__ void build_table(const ge& a, const int32_t* sm,
                                            int32_t* tab, size_t stride,
                                            size_t col) {
  const fe d2 = fe_const(sm + C_D2);
  gn ident;
  ident.ypx = fe_small(1);
  ident.ymx = fe_small(1);
  ident.z2 = fe_small(2);
  ident.t2d = fe_small(0);
  store_niels(tab, stride, col, 0, ident);
  store_niels(tab, stride, col, 1, to_niels(a, d2));
  const gan a3 = to_affine_niels(a, d2);
  ge cur = ge_double(a);
  store_niels(tab, stride, col, 2, to_niels(cur, d2));
#pragma unroll 1
  for (int k = 3; k < TSIZE; ++k) {
    cur = ge_add_affine(cur, a3);
    store_niels(tab, stride, col, k, to_niels(cur, d2));
  }
}

}  // namespace ed
