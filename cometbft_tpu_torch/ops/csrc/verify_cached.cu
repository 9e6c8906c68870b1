// K2 k2_verify_cached: verification with a pre-expanded pubkey table.
// Replaces cometbft_tpu/ops/pallas_verify.py _verify_block_kernel_cached
// (wrapper verify_kernel_cached). A's table is read straight from the
// pubkey arena by the lane's uint16 slot, so only R decompresses and no
// gathered (16, 4, 20, N) copy is made.
//
// What bounds it: 32-bit multiply-adds. A lane does 2,023 field
// multiplications and 1,291 squarings (R's decompression, then 64 windows
// of four doublings, an arena add and a B add, then -R and three
// doublings), ~2.6 M operations against ~5.7 KB of inputs: far past the
// card's ops-per-byte line (ops/cuda_verify.MULADDS_PER_LANE).
//
// Design (fe26.cuh): 26-bit limbs, so a product is 100 IMAD.WIDE into
// 64-bit columns, and four threads a lane on the parallel Edwards
// formulas, so each thread's chain is ~1,050 field operations, not
// ~3,300, and 10,000 lanes put 1,250 warps on the 528 schedulers where one
// thread a lane gave 313. Blocks are one warp (8 lanes), so the warps of
// any launch spread over the SMs within one of even (3,334 lanes: 3-4 an
// SM, 10,000: 9-10); two- and four-warp blocks timed within the noise of
// this shape on the card (PERF.md). 12 blocks an SM must fit (168
// registers a thread), so 10,000 lanes run in one wave.
// Thread c reads plane (Y-X, Y+X, 2Z, 2dT)[c] of A's arena entry, so no
// table byte is read twice; the B table (16 affine-Niels entries) and d,
// 2d, sqrt(-1) are paired into shared memory once a block. R's
// decompression (255 squarings) has no four-way form: all four threads of
// a quad run it side by side. Quads past N run on lane N - 1 and store
// nothing, since a thread that returned would break its quad's shuffles.
// The tensor cores do not help: every lane multiplies its own operands,
// so no matrix is shared that a wgmma tile could hold.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

constexpr int BLOCK = 32;
constexpr int LANES = BLOCK / 4;  // lanes a block
constexpr int NL13 = 20;          // 13-bit limbs of an arena element

extern "C" __global__ void __launch_bounds__(BLOCK, 12)
    k2_verify_cached(const int32_t* __restrict__ arena,
                     const uint8_t* __restrict__ arena_ok,
                     const uint16_t* __restrict__ idxs, int slots,
                     const int32_t* __restrict__ y_r,
                     const int32_t* __restrict__ sign_r,
                     const int32_t* __restrict__ s_nibs,
                     const int32_t* __restrict__ kneg_nibs,
                     const int32_t* __restrict__ consts,
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
  const fe ry = fe_load13(y_r + ln, n);
  fe rx;
  ok &= decompress_x(rx, ry, sign_r[ln], sm);
  const fe nr = q_neg_affine(rx, ry, fe_const(sm + C_D2), c);

  // planes of an arena entry: (Y+X, Y-X, 2Z, 2dT); of a B entry:
  // (y+x, y-x, 2dxy)
  const int aplane = c < 2 ? c ^ 1 : c;
  const int bplane = c == 0 ? 1 : (c == 1 ? 0 : 2);
  const int32_t* acol = arena + (size_t)aplane * NL13 * slots + slot;
  fe acc = q_identity(c);
#pragma unroll 1
  for (int j = 0; j < 64; ++j) {
    const int kn = kneg_nibs[(size_t)j * n + ln] & (TSIZE - 1);
    const int sn = s_nibs[(size_t)j * n + ln] & (TSIZE - 1);
    // the arena row is in flight during the doublings
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
    const fe nb = fe_const(sm + C_BTAB + (sn * 3 + bplane) * NL);
    acc = q_add(acc, fe_select(c == 2, fe_small(2), nb), c);
  }
  ok &= q_minus_r_is_small(acc, nr, c);
  if (live && c == 0) out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify_cached(
    const int32_t* arena, const uint8_t* arena_ok, const uint16_t* idxs,
    int slots, const int32_t* y_r, const int32_t* sign_r,
    const int32_t* s_nibs, const int32_t* kneg_nibs, const int32_t* consts,
    uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k2_verify_cached<<<(n + LANES - 1) / LANES, BLOCK, 0, stream>>>(
      arena, arena_ok, idxs, slots, y_r, sign_r, s_nibs, kneg_nibs, consts,
      out, n);
  return (int)cudaGetLastError();
}
