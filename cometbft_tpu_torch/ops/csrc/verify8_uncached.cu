// K3 k3_verify8: batched cofactored ed25519 verification, uncached path,
// 8-bit fixed-base flavor. Replaces cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel8 (wrapper verify_kernel8): decompress A and R,
// build A's 16-entry Niels table into a lane-minor (16, 4, 20, N) global
// scratch (as K1), [S]B from 32 fixed-base 8-bit windows of the
// (32, 256, 3, 20) table in global memory, the A-only 4-bit ladder, one
// complete add, -R, x8 and the identity test. Against K1 the ladder drops
// its 64 B adds for 32 adds and one complete add: 1,789 field
// multiplications instead of 2,004, paid for with 32 table gathers of
// 240 B a lane from L2. See kernel_common.cuh for the bound and the
// design.
#include "kernel_common.cuh"

using namespace ed;

extern "C" __global__ void __launch_bounds__(BLOCK)
    k3_verify8(const int32_t* __restrict__ y_a,
               const int32_t* __restrict__ sign_a,
               const int32_t* __restrict__ y_r,
               const int32_t* __restrict__ sign_r,
               const int32_t* __restrict__ s_bytes,
               const int32_t* __restrict__ kneg_nibs,
               const int32_t* __restrict__ consts,
               const int32_t* __restrict__ tab8,
               int32_t* __restrict__ scratch, uint8_t* __restrict__ out,
               int n) {
  __shared__ int32_t sm[N_CONSTS];
  __shared__ int32_t stash[STASH];
  stage_consts(sm, consts);
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n) return;
  bool ok;
  {
    ge a;
    ok = ge_decompress(a, fe_load(y_a + lane, n), sign_a[lane], sm);
    build_table(a, sm, scratch, n, lane);
  }
  ge_stash(stash, fixed_base_sum8(tab8, s_bytes, n, lane));
  ge r;
  ok &= ge_decompress(r, fe_load(y_r + lane, n), sign_r[lane], sm);
  ge acc = ladder_a_only(scratch, n, lane, kneg_nibs, n, lane);
  acc = ge_add_full(acc, ge_unstash(stash), fe_const(sm + C_D2));
  ok &= minus_r_is_small(acc, r, sm);
  out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify8(const int32_t* y_a, const int32_t* sign_a,
                               const int32_t* y_r, const int32_t* sign_r,
                               const int32_t* s_bytes,
                               const int32_t* kneg_nibs,
                               const int32_t* consts, const int32_t* tab8,
                               int32_t* scratch, uint8_t* out, int n,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  k3_verify8<<<grid_for(n), BLOCK, 0, stream>>>(
      y_a, sign_a, y_r, sign_r, s_bytes, kneg_nibs, consts, tab8, scratch,
      out, n);
  return (int)cudaGetLastError();
}
