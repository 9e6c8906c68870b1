// K4 k4_verify8_cached: verification with a pre-expanded pubkey table,
// 8-bit fixed-base flavor. Replaces cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel8_cached (wrapper verify_kernel8_cached). A's table
// is read straight from the pubkey arena by the lane's uint16 slot, as K2
// reads it, so only R decompresses and no gathered copy is made; [S]B
// comes from the 8-bit fixed-base table as in K3. See kernel_common.cuh
// for the bound and the design.
#include "kernel_common.cuh"

using namespace ed;

extern "C" __global__ void __launch_bounds__(BLOCK)
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
  __shared__ int32_t sm[N_CONSTS];
  __shared__ int32_t stash[STASH];
  stage_consts(sm, consts);
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n) return;
  int slot = idxs[lane];
  bool ok = slot < slots;  // an out-of-range slot verifies False
  if (!ok) slot = 0;
  ok &= arena_ok[slot] != 0;
  ge_stash(stash, fixed_base_sum8(tab8, s_bytes, n, lane));
  ge r;
  ok &= ge_decompress(r, fe_load(y_r + lane, n), sign_r[lane], sm);
  ge acc = ladder_a_only(arena, slots, slot, kneg_nibs, n, lane);
  acc = ge_add_full(acc, ge_unstash(stash), fe_const(sm + C_D2));
  ok &= minus_r_is_small(acc, r, sm);
  out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify8_cached(
    const int32_t* arena, const uint8_t* arena_ok, const uint16_t* idxs,
    int slots, const int32_t* y_r, const int32_t* sign_r,
    const int32_t* s_bytes, const int32_t* kneg_nibs, const int32_t* consts,
    const int32_t* tab8, uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k4_verify8_cached<<<grid_for(n), BLOCK, 0, stream>>>(
      arena, arena_ok, idxs, slots, y_r, sign_r, s_bytes, kneg_nibs, consts,
      tab8, out, n);
  return (int)cudaGetLastError();
}
