// K3 k3_verify8: batched cofactored ed25519 verification, uncached path,
// 8-bit fixed-base flavor. Replaces cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel8 (wrapper verify_kernel8): decompress A and R, build
// A's 16-entry Niels table, [S]B from 32 fixed-base 8-bit windows, the
// A-only 4-bit ladder, one complete add, -R, x8 and the identity test.
//
// What bounds it: 32-bit multiply-adds. A lane does 1,938 field
// multiplications and 1,550 squarings (K1's minus the 64 B adds, plus 32
// affine adds and one complete add): far past the card's ops-per-byte
// line (ops/cuda_verify.MULADDS_PER_LANE).
//
// Design: K1's (verify_uncached.cu: four threads a lane on fe26.cuh, A and
// R decompressed by different thread pairs, A's table built by the quad
// into shared memory, 10 one-warp blocks an SM) with K4's [S]B
// (verify8_cached.cu): thread c holds coordinate c of [S]B in 10 registers
// through the A ladder, and reads its 40 B plane of each fixed-base entry
// from the paired copy ops/cuda_verify._base_table8_26. The complete add
// that joins the two sums is one round that puts [S]B in Niels form and a
// Niels add.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

constexpr int BLOCK = 32;
constexpr int LANES = BLOCK / 4;  // lanes a block

extern "C" __global__ void __launch_bounds__(BLOCK, 10)
    k3_verify8(const int32_t* __restrict__ y_a,
               const int32_t* __restrict__ sign_a,
               const int32_t* __restrict__ y_r,
               const int32_t* __restrict__ sign_r,
               const int32_t* __restrict__ s_bytes,
               const int32_t* __restrict__ kneg_nibs,
               const int32_t* __restrict__ consts,
               const int32_t* __restrict__ tab8,
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
  // [S]B after A's table: summed first, it was live through the
  // decompressions and ptxas spilled
  const fe sb = q_fixed_base8(tab8, s_bytes, n, ln, c);

  fe acc = q_identity(c);
#pragma unroll 1
  for (int j = 0; j < 64; ++j) {
    const int kn = kneg_nibs[(size_t)j * n + ln] & (TSIZE - 1);
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = q_double(acc, c);
    acc = q_add(acc, atab_load(atab, kn, c), c);
  }
  acc = q_add(acc, q_to_niels(sb, fe_const(sm + C_D2), c), c);
  ok &= q_minus_r_is_small(acc, nr, c);
  if (live && c == 0) out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t. `tab8`
// is the paired fixed-base table (ops/cuda_verify._base_table8_26).
extern "C" int ed25519_verify8(const int32_t* y_a, const int32_t* sign_a,
                               const int32_t* y_r, const int32_t* sign_r,
                               const int32_t* s_bytes,
                               const int32_t* kneg_nibs,
                               const int32_t* consts, const int32_t* tab8,
                               uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int err = prefer_max_shared(k3_verify8);
  if (err != 0) return err;
  k3_verify8<<<(n + LANES - 1) / LANES, BLOCK, 0, stream>>>(
      y_a, sign_a, y_r, sign_r, s_bytes, kneg_nibs, consts, tab8, out, n);
  return (int)cudaGetLastError();
}
