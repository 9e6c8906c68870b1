// X1 x1_build_tables: decompress pubkeys and expand their 16-entry Niels
// tables for the pubkey arena. Replaces the XLA program the reference
// builds the arena with (cometbft_tpu/ops/verify.py _builder_kernel ->
// curve.build_pubkey_tables). See kernel_common.cuh for the bound.
#include "kernel_common.cuh"

using namespace ed;

extern "C" __global__ void __launch_bounds__(BLOCK)
    x1_build_tables(const int32_t* __restrict__ y_a,
                    const int32_t* __restrict__ sign_a,
                    const int32_t* __restrict__ consts,
                    int32_t* __restrict__ table, uint8_t* __restrict__ ok,
                    int n) {
  __shared__ int32_t sm[N_CONSTS];
  stage_consts(sm, consts);
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)n) return;
  ge a;
  const bool dec = ge_decompress(a, fe_load(y_a + lane, n), sign_a[lane], sm);
  build_table(a, sm, table, n, lane);
  ok[lane] = dec ? 1 : 0;
}

// C entry (ctypes): launches on `stream`, returns the cudaError_t.
extern "C" int ed25519_build_tables(const int32_t* y_a, const int32_t* sign_a,
                                    const int32_t* consts, int32_t* table,
                                    uint8_t* ok, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  x1_build_tables<<<grid_for(n), BLOCK, 0, stream>>>(y_a, sign_a, consts,
                                                     table, ok, n);
  return (int)cudaGetLastError();
}
