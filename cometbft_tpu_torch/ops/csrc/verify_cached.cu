// K2 k2_verify_cached: verification with a pre-expanded pubkey table.
// Replaces cometbft_tpu/ops/pallas_verify.py _verify_block_kernel_cached
// (wrapper verify_kernel_cached). A's table is read straight from the
// pubkey arena by the lane's uint16 slot, so only R decompresses and no
// gathered (16, 4, 20, N) copy is made. See kernel_common.cuh for the
// bound and the design.
#include "kernel_common.cuh"

using namespace ed;

extern "C" __global__ void __launch_bounds__(BLOCK)
    k2_verify_cached(const int32_t* __restrict__ arena,
                     const uint8_t* __restrict__ arena_ok,
                     const uint16_t* __restrict__ idxs, int slots,
                     const int32_t* __restrict__ y_r,
                     const int32_t* __restrict__ sign_r,
                     const int32_t* __restrict__ s_nibs,
                     const int32_t* __restrict__ kneg_nibs,
                     const int32_t* __restrict__ consts,
                     uint8_t* __restrict__ out, int n) {
  __shared__ int32_t sm[N_CONSTS];
  stage_consts(sm, consts);
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n) return;
  int slot = idxs[lane];
  bool ok = slot < slots;  // an out-of-range slot verifies False
  if (!ok) slot = 0;
  ok &= arena_ok[slot] != 0;
  ge r;
  ok &= ge_decompress(r, fe_load(y_r + lane, n), sign_r[lane], sm);
  ok &= ladder_check(arena, slots, slot, r, s_nibs, kneg_nibs, n, lane, sm);
  out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify_cached(
    const int32_t* arena, const uint8_t* arena_ok, const uint16_t* idxs,
    int slots, const int32_t* y_r, const int32_t* sign_r,
    const int32_t* s_nibs, const int32_t* kneg_nibs, const int32_t* consts,
    uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k2_verify_cached<<<grid_for(n), BLOCK, 0, stream>>>(
      arena, arena_ok, idxs, slots, y_r, sign_r, s_nibs, kneg_nibs, consts,
      out, n);
  return (int)cudaGetLastError();
}

