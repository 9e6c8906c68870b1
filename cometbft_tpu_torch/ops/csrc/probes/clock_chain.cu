// A measurement probe, not a kernel of the port: one warp times 32-bit
// integer instructions with the SM's cycle counter (clock64), and the
// caller times each launch with CUDA events too (cycles over milliseconds
// is the SM clock). chip_smoke.py builds it beside the kernels
// (ops/build.py) to price X4's and X1's chain bounds and read issue
// rates.
// - latency: a chain of dependent instructions, a funnel shift, a LOP3
//   and an add in turn (the three steps of SHA-256's round chain); with
//   IMAD the add is a multiply-add by `one` (a kernel argument equal to
//   1), an IMAD on the FMA pipe, as X4's round warp writes its additions.
//   Cycles over instructions is the dependent-issue latency.
// - rate: eight independent chains of one instruction (SHF, LOP3, IADD3,
//   IMAD or IMAD.WIDE.U32, the 32 x 32 -> 64-bit multiply-add of
//   fe26.cuh): cycles over instructions is what one warp issues of it.
// - wide latency: a chain of dependent IMAD.WIDE.U32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 32;  // steps a loop turn
constexpr int CHAINS = 8;  // independent chains of a rate run

template <bool IMAD>
__global__ void clock_chain(uint32_t x, uint32_t y, uint32_t z, int turns,
                            uint32_t one, uint32_t* out, long long* cycles) {
  x += threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < turns; ++i) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      x = __funnelshift_r(x, x, 7);
      x = (x ^ y) & z ^ y;
      x = IMAD ? x * one + y : x + y;
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// a chain of 64-bit multiply-adds, each reading the last one's result
__global__ void clock_wide_chain(uint32_t x, uint32_t y, uint32_t z,
                                 int turns, uint32_t one, uint32_t* out,
                                 long long* cycles) {
  uint64_t w = x + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < turns; ++i) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) w = (uint64_t)(uint32_t)w * one + w;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = (uint32_t)(w ^ (w >> 32)) ^ y ^ z;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// OP 0: SHF, 1: LOP3, 2: IADD3, 3: IMAD, 4: IMAD.WIDE.U32
template <int OP>
__global__ void clock_rate(uint32_t x, uint32_t y, uint32_t z, int turns,
                           uint32_t one, uint32_t* out, long long* cycles) {
  uint32_t v[CHAINS];
  uint64_t w[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    v[k] = x + threadIdx.x * CHAINS + k;
    w[k] = v[k];
  }
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < turns; ++i) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        // LOP3 and IADD3 mix in the next chain, so that no two steps fold
        const uint32_t n = v[(k + 1) % CHAINS];
        if (OP == 0) v[k] = __funnelshift_r(v[k], v[k], 7);
        if (OP == 1) v[k] = (v[k] & z) ^ n;
        if (OP == 2) v[k] = v[k] + n + z;
        if (OP == 3) v[k] = v[k] * one + y;
        if (OP == 4) w[k] = (uint64_t)(uint32_t)w[k] * one + w[k];
      }
    }
  }
  const long long t1 = clock64();
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) r ^= OP == 4 ? (uint32_t)(w[k] >> 7) : v[k];
  out[threadIdx.x] = r;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

// C entry (ctypes): one warp, `turns` loop turns; mode 0 the latency
// chain with adds, 1 with IMADs (3 * STEPS dependent instructions a
// turn), 2-6 the rate of SHF, LOP3, IADD3, IMAD, IMAD.WIDE.U32 (CHAINS *
// STEPS a turn), 7 the IMAD.WIDE.U32 chain (STEPS a turn).
// Returns the cudaError_t of the launch.
extern "C" int clock_chain_run(uint32_t x, uint32_t y, uint32_t z, int turns,
                               int mode, uint32_t* out, long long* cycles,
                               cudaStream_t stream) {
  switch (mode) {
    case 0:
      clock_chain<false><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out,
                                               cycles);
      break;
    case 1:
      clock_chain<true><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    case 2:
      clock_rate<0><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    case 3:
      clock_rate<1><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    case 4:
      clock_rate<2><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    case 5:
      clock_rate<3><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    case 6:
      clock_rate<4><<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out, cycles);
      break;
    default:
      clock_wide_chain<<<1, 32, 0, stream>>>(x, y, z, turns, 1u, out,
                                             cycles);
  }
  return (int)cudaGetLastError();
}

// instructions a turn of `mode` times
extern "C" int clock_chain_steps(int mode) {
  return mode < 2 ? 3 * STEPS : (mode == 7 ? STEPS : CHAINS * STEPS);
}
