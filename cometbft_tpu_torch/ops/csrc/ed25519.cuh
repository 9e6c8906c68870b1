// GF(2^255 - 19) on the reference's limbs, for the table half of the
// arena builder X1 (build_tables.cu): what it needs to write the
// reference's arena limb for limb. X1 decompresses on fe26.cuh; the verify
// kernels K1-K4 run on fe26.cuh alone.
//
// A field element is 20 limbs of 13 bits in int32 with the lazy-carry
// discipline of ops/field.py: every op takes limbs <= 10015 and returns
// limbs <= 10015, add/sub/neg/dbl2 carry once and the mul column fold
// three times. A schoolbook column holds at most 20 products of <= 10015^2
// < 2^31, so no int32 intermediate overflows (the interval proof for this
// representation is tests/test_field.py's). Every op here computes the
// same limbs as its counterpart in ops/field.py; a squaring is fe_mul(a,
// a), whose columns are those of field.sq.
//
// Lane-minor arrays: element (row, lane) of an array with `stride` lanes
// sits at row * stride + lane, so neighbouring threads read neighbouring
// addresses.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace ed {

constexpr int NL = 20;
constexpr int BITS = 13;
constexpr int32_t MASK = (1 << BITS) - 1;
constexpr int32_t FOLD = 608;  // 2^260 == 19 * 2^5 (mod p)

struct fe {
  int32_t v[NL];
};

// Subtraction bias: == 0 mod p, every limb >= 8191 (ops/field._SUB_BIAS).
__device__ __forceinline__ int32_t sub_bias(int i) {
  return i == 0 ? 16382 - 1214 : 16382;
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

// a + b (field.add) or, where `minus`, a - b (field.sub: a + bias - b).
__device__ __forceinline__ fe fe_add_sub(const fe& a, const fe& b,
                                         bool minus) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = a.v[i] + (minus ? sub_bias(i) - b.v[i] : b.v[i]);
  carry1(r);
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  return fe_add_sub(a, b, false);
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

__device__ __forceinline__ fe fe_small(int32_t v0) {
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

// Element of thread `src` (0-3) of this quad; every thread of the warp
// must reach it.
__device__ __forceinline__ fe fe_shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i)
    r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, 4);
  return r;
}

}  // namespace ed
