// Shared by the kernel sources on ed25519.cuh, now only X1
// (build_tables.cu, x1_build_tables): one thread a pubkey lane, which
// replaces the XLA program the reference builds the pubkey arena with
// (cometbft_tpu/ops/verify.py _builder_kernel ->
// curve.build_pubkey_tables). The verify kernels K1-K4 are built on
// fe26.cuh (26-bit limbs, four threads a lane) and do not include this
// file.
//
// What bounds X1: 32-bit multiply-adds. A lane does ~130 field
// multiplications and ~260 squarings (A's decompression and its table),
// each a 20x20 schoolbook of 400 int32 multiply-adds here (210 for a
// squaring), against 5,205 B per lane (the table written once): above the
// card's ops-per-byte line. The bound prices every field operation at the
// fewest 32-bit multiply-adds a 255-bit product takes (128 a
// multiplication, 72 a squaring; ops/cuda_verify.MULADDS_PER_LANE), 2
// operations each, over the int32 multiply-add rate (64 per clock per SM
// on sm_90, half the float32 FMA rate), and bytes (each input read once,
// each output written once) over the memory rate; the larger is the
// bound.
//
// Design: the constant B table and d, 2d, sqrt(-1) sit in shared memory,
// staged once per block. The table goes to a lane-minor (16, 4, 20, M)
// output the wrapper allocates. Any M is taken: the grid covers
// ceil(M / BLOCK) blocks and the ragged edge is masked. Launches go on the
// caller's stream; nothing synchronises.
#pragma once

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace ed {

constexpr int BLOCK = 64;

__device__ __forceinline__ void stage_consts(int32_t* sm,
                                             const int32_t* consts) {
  for (int i = threadIdx.x; i < N_CONSTS; i += blockDim.x) sm[i] = consts[i];
  __syncthreads();
}

inline int grid_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace ed
