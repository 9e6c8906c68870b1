// K1 k1_verify: batched cofactored ed25519 verification, uncached path.
// Replaces cometbft_tpu/ops/pallas_verify.py _verify_block_kernel (wrapper
// verify_kernel): decompress A and R, build A's 16-entry Niels table into
// a lane-minor (16, 4, 20, N) global scratch (5,120 B a lane: too big for
// registers or shared memory), the 64-window joint ladder, -R, x8 and the
// identity test. See kernel_common.cuh for the bound and the design.
#include "kernel_common.cuh"

using namespace ed;

extern "C" __global__ void __launch_bounds__(BLOCK)
    k1_verify(const int32_t* __restrict__ y_a,
              const int32_t* __restrict__ sign_a,
              const int32_t* __restrict__ y_r,
              const int32_t* __restrict__ sign_r,
              const int32_t* __restrict__ s_nibs,
              const int32_t* __restrict__ kneg_nibs,
              const int32_t* __restrict__ consts, int32_t* __restrict__ scratch,
              uint8_t* __restrict__ out, int n) {
  __shared__ int32_t sm[N_CONSTS];
  stage_consts(sm, consts);
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n) return;
  bool ok;
  {
    ge a;
    ok = ge_decompress(a, fe_load(y_a + lane, n), sign_a[lane], sm);
    build_table(a, sm, scratch, n, lane);
  }
  ge r;
  ok &= ge_decompress(r, fe_load(y_r + lane, n), sign_r[lane], sm);
  ok &= ladder_check(scratch, n, lane, r, s_nibs, kneg_nibs, n, lane, sm);
  out[lane] = ok ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_verify(const int32_t* y_a, const int32_t* sign_a,
                              const int32_t* y_r, const int32_t* sign_r,
                              const int32_t* s_nibs, const int32_t* kneg_nibs,
                              const int32_t* consts, int32_t* scratch,
                              uint8_t* out, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  k1_verify<<<grid_for(n), BLOCK, 0, stream>>>(
      y_a, sign_a, y_r, sign_r, s_nibs, kneg_nibs, consts, scratch, out, n);
  return (int)cudaGetLastError();
}

