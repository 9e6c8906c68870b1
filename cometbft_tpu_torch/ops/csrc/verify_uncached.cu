// K1 k1_verify: batched cofactored ed25519 verification, uncached path.
// Replaces cometbft_tpu/ops/pallas_verify.py _verify_block_kernel (wrapper
// verify_kernel): decompress A and R, build A's 16-entry Niels table, the
// 64-window joint ladder, -R, x8 and the identity test.
//
// What bounds it: 32-bit multiply-adds. A lane does 2,153 field
// multiplications and 1,550 squarings (two decompressions, the table
// build, 64 windows of four doublings, an A add and a B add, then -R and
// three doublings), ~0.77 M operations at the bound's pricing against
// 681 B of inputs and output: far past the card's ops-per-byte line
// (ops/cuda_verify.MULADDS_PER_LANE).
//
// Design: K2's (verify_cached.cu, fe26.cuh) with the part only the
// uncached kernels have. 26-bit limbs with 64-bit products, four threads a
// lane on the parallel Edwards formulas, one-warp blocks of 8 lanes; quads
// past N run on lane N - 1 and store nothing. Threads 0-1 decompress A
// while threads 2-3 decompress R, so each thread's chain holds one
// decompression, as in K2. The quad then builds A's table into shared
// memory, thread c keeping only its plane (Y-X, Y+X, 2Z, 2dT)[c] of each
// entry (19,200 B a block), so no table byte goes to device memory. With
// the staged constants a block holds ~21 KB of shared memory, so 10 blocks
// an SM fit (the carveout is set to its maximum) and 10,000 lanes run in
// one wave of 1,250 blocks. The tensor cores do not help: every lane
// multiplies its own operands.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

constexpr int BLOCK = 32;
constexpr int LANES = BLOCK / 4;  // lanes a block

extern "C" __global__ void __launch_bounds__(BLOCK, 10)
    k1_verify(const int32_t* __restrict__ y_a,
              const int32_t* __restrict__ sign_a,
              const int32_t* __restrict__ y_r,
              const int32_t* __restrict__ sign_r,
              const int32_t* __restrict__ s_nibs,
              const int32_t* __restrict__ kneg_nibs,
              const int32_t* __restrict__ consts,
              uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t atab[ATAB_WORDS];
  stage_consts26(sm, consts);
  const int c = quad_c();
  const size_t lane = (size_t)blockIdx.x * LANES + (threadIdx.x >> 2);
  const bool live = lane < (size_t)n;
  const size_t ln = live ? lane : (size_t)n - 1;
  fe nr;
  bool ok = q_decompress_ar(y_a, sign_a, y_r, sign_r, n, ln, sm, atab, nr, c);

  // planes of a B entry: (y+x, y-x, 2dxy)
  const int bplane = c == 0 ? 1 : (c == 1 ? 0 : 2);
  fe acc = q_identity(c);
#pragma unroll 1
  for (int j = 0; j < 64; ++j) {
    const int kn = kneg_nibs[(size_t)j * n + ln] & (TSIZE - 1);
    const int sn = s_nibs[(size_t)j * n + ln] & (TSIZE - 1);
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = q_double(acc, c);
    acc = q_add(acc, atab_load(atab, kn, c), c);
    const fe nb = fe_const(sm + C_BTAB + (sn * 3 + bplane) * NL);
    acc = q_add(acc, fe_select(c == 2, fe_small(2), nb), c);
  }
  ok &= q_minus_r_is_small(acc, nr, c);
  if (live && c == 0) out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify(const int32_t* y_a, const int32_t* sign_a,
                              const int32_t* y_r, const int32_t* sign_r,
                              const int32_t* s_nibs, const int32_t* kneg_nibs,
                              const int32_t* consts, uint8_t* out, int n,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int err = prefer_max_shared(k1_verify);
  if (err != 0) return err;
  k1_verify<<<(n + LANES - 1) / LANES, BLOCK, 0, stream>>>(
      y_a, sign_a, y_r, sign_r, s_nibs, kneg_nibs, consts, out, n);
  return (int)cudaGetLastError();
}
