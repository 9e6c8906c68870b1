// K4 k4_verify8_cached: verification with a pre-expanded pubkey table,
// 8-bit fixed-base flavor. Replaces cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel8_cached (wrapper verify_kernel8_cached). A's table
// is read straight from the pubkey arena by the lane's uint16 slot, as K2
// reads it, so only R decompresses and no gathered copy is made; [S]B is
// the sum of 32 fixed-base 8-bit windows, as in K3.
//
// What bounds it: 32-bit multiply-adds. A lane does 1,808 field
// multiplications and 1,291 squarings (the fixed-base sum, R's
// decompression, 64 windows of four doublings and an arena add, the
// complete add that joins [S]B, then -R and three doublings): far past
// the card's ops-per-byte line (ops/cuda_verify.MULADDS_PER_LANE).
//
// Design: K2's (verify_cached.cu, fe26.cuh): 26-bit limbs with 64-bit
// products, four threads a lane on the parallel Edwards formulas, one-warp
// blocks. Thread c holds coordinate c of [S]B in 10 registers through the
// A ladder, where one thread a lane parked the whole point in shared
// memory. The complete add that joins the two sums is one round that
// puts [S]B in Niels form (a multiplication by 2d in thread 3) and a Niels
// add. The fixed-base table is the paired copy ops/cuda_verify builds once
// a device from curve.base_table8: entry (j, v) is 32 int32, (y+x, y-x,
// 2dxy) in 26-bit limbs and two words of padding, 128 B aligned, and
// thread c reads its 10 words (fe26.cuh q_fixed_base8, shared with K3).
// Pairing the 13-bit table on load would read 80 B a thread, where the
// copy holds the same entry in 40.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

constexpr int BLOCK = 32;
constexpr int LANES = BLOCK / 4;  // lanes a block
constexpr int NL13 = 20;          // 13-bit limbs of an arena element

extern "C" __global__ void __launch_bounds__(BLOCK, 12)
    k4_verify8_cached(const int32_t* __restrict__ arena,
                      const uint8_t* __restrict__ arena_ok,
                      const uint16_t* __restrict__ idxs, int slots,
                      const int32_t* __restrict__ y_r,
                      const int32_t* __restrict__ sign_r,
                      const int32_t* __restrict__ s_bytes,
                      const int32_t* __restrict__ kneg_nibs,
                      const int32_t* __restrict__ consts,
                      const int32_t* __restrict__ tab8,
                      uint8_t* __restrict__ out, int n) {
  __shared__ uint32_t sm[N_CONSTS];
  stage_consts26(sm, consts);
  const int c = quad_c();
  const size_t lane = (size_t)blockIdx.x * LANES + (threadIdx.x >> 2);
  const bool live = lane < (size_t)n;
  const size_t ln = live ? lane : (size_t)n - 1;
  int slot = idxs[ln];
  bool ok = slot < slots;  // an out-of-range slot verifies False
  if (!ok) slot = 0;
  ok &= arena_ok[slot] != 0;

  const fe sb = q_fixed_base8(tab8, s_bytes, n, ln, c);

  const fe ry = fe_load13(y_r + ln, n);
  fe rx;
  ok &= decompress_x(rx, ry, sign_r[ln], sm);
  const fe d2 = fe_const(sm + C_D2);
  const fe nr = q_neg_affine(rx, ry, d2, c);

  const int aplane = c < 2 ? c ^ 1 : c;
  const int32_t* acol = arena + (size_t)aplane * NL13 * slots + slot;
  fe acc = q_identity(c);
#pragma unroll 1
  for (int j = 0; j < 64; ++j) {
    const int kn = kneg_nibs[(size_t)j * n + ln] & (TSIZE - 1);
    int32_t raw[NL13];
    const int32_t* row = acol + (size_t)kn * 4 * NL13 * slots;
#pragma unroll
    for (int l = 0; l < NL13; ++l) raw[l] = row[(size_t)l * slots];
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = q_double(acc, c);
    fe na;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      na.v[i] = (uint32_t)raw[2 * i] + ((uint32_t)raw[2 * i + 1] << 13);
    acc = q_add(acc, na, c);
  }
  acc = q_add(acc, q_to_niels(sb, d2, c), c);
  ok &= q_minus_r_is_small(acc, nr, c);
  if (live && c == 0) out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t. `tab8`
// is the paired fixed-base table (ops/cuda_verify._base_table8_26).
extern "C" int ed25519_verify8_cached(
    const int32_t* arena, const uint8_t* arena_ok, const uint16_t* idxs,
    int slots, const int32_t* y_r, const int32_t* sign_r,
    const int32_t* s_bytes, const int32_t* kneg_nibs, const int32_t* consts,
    const int32_t* tab8, uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k4_verify8_cached<<<(n + LANES - 1) / LANES, BLOCK, 0, stream>>>(
      arena, arena_ok, idxs, slots, y_r, sign_r, s_bytes, kneg_nibs, consts,
      tab8, out, n);
  return (int)cudaGetLastError();
}
