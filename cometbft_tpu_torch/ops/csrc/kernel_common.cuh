// Shared by the kernel sources K1, K3 and X1: batched cofactored ed25519
// verification for Hopper (sm_90a), one thread per signature lane, on the
// field and point code of ed25519.cuh. The cached kernels K2 and K4 are
// built on fe26.cuh instead (26-bit limbs, four threads a lane) and do not
// include this file.
//
//   K1 k1_verify         replaces cometbft_tpu/ops/pallas_verify.py
//                        _verify_block_kernel (wrapper verify_kernel):
//                        decompress A and R, build A's 16-entry table,
//                        64-window joint ladder, -R, x8, identity test.
//   K2 k2_verify_cached  replaces _verify_block_kernel_cached (wrapper
//                        verify_kernel_cached): A's table is read straight
//                        from the pubkey arena by slot index, so only R
//                        decompresses and no gathered table copy is made.
//                        verify_cached.cu, on fe26.cuh.
//   X1 x1_build_tables   replaces the XLA builder that fills the arena
//                        (ops/verify.py _builder_kernel ->
//                        curve.build_pubkey_tables).
//   K3 k3_verify8        replaces _verify_block_kernel8 (wrapper
//                        verify_kernel8): K1 with [S]B taken from 32
//                        fixed-base 8-bit windows instead of inside the
//                        joint ladder, joined by one complete add.
//   K4 k4_verify8_cached replaces _verify_block_kernel8_cached (wrapper
//                        verify_kernel8_cached): K3 with K2's arena read.
//                        verify8_cached.cu, on fe26.cuh.
//
// What bounds them: 32-bit multiply-adds. K2 does ~2,020 field muls and
// ~1,290 squarings per lane (K1 ~2,150 and ~1,550, X1 ~130 and ~260); here
// each is a 20x20 schoolbook of 400 int32 multiply-adds (210 for a
// squaring), against ~5.7 KB per lane (K2, table rows included): far above
// the card's ops-per-byte line, so the kernels are compute-bound. The
// bound prices every field operation at the fewest 32-bit multiply-adds a
// 255-bit product takes (128 a multiplication, 72 a squaring;
// ops/cuda_verify.MULADDS_PER_LANE), 2 operations each, over the int32
// multiply-add rate (64 per clock per SM on sm_90, half the float32 FMA
// rate), and bytes (each input read once, each output written once) over
// the memory rate; the larger is the bound.
//
// Design: the Pallas kernels' one-hot multiply-accumulate selects become
// plain indexed loads (the inputs are public, so constant time is not
// required). The constant B table and d, 2d, sqrt(-1) sit in shared memory,
// staged once per block; per-lane reads of it diverge, which constant
// memory would serialise. K1's per-lane A table (5,120 B) lives in a
// lane-minor (16, 4, 20, N) global scratch the wrapper allocates. Any N
// is taken: the grid covers ceil(N / BLOCK) blocks and the ragged edge is
// masked. 64 threads a block spread 10,000 lanes over 157 blocks on 132
// SMs. Launches go on the caller's stream; nothing synchronises. Each
// kernel is its own source so the nvcc runs go in parallel.
//
// K3 computes the fixed-base sum [S]B first and parks it in shared
// memory (80 int32 a thread, 20 KB a block) while the A ladder runs, so
// the ladder has the registers of K1's and the two points meet only at
// the final complete add.
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

// A point parked in shared memory, one column a thread: element
// (coordinate, limb) of thread t at [(c * NL + limb) * BLOCK + t], so a
// warp's accesses fall in distinct banks.
constexpr int STASH = 4 * NL * BLOCK;

__device__ __forceinline__ void fe_stash(int32_t* p, const fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i * BLOCK + threadIdx.x] = a.v[i];
}

__device__ __forceinline__ fe fe_unstash(const int32_t* p) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = p[i * BLOCK + threadIdx.x];
  return r;
}

__device__ __forceinline__ void ge_stash(int32_t* st, const ge& p) {
  fe_stash(st, p.x);
  fe_stash(st + NL * BLOCK, p.y);
  fe_stash(st + 2 * NL * BLOCK, p.z);
  fe_stash(st + 3 * NL * BLOCK, p.t);
}

__device__ __forceinline__ ge ge_unstash(const int32_t* st) {
  ge r;
  r.x = fe_unstash(st);
  r.y = fe_unstash(st + NL * BLOCK);
  r.z = fe_unstash(st + 2 * NL * BLOCK);
  r.t = fe_unstash(st + 3 * NL * BLOCK);
  return r;
}

}  // namespace ed

