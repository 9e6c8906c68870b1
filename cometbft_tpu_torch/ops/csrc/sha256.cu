// X4 x4_sha256: SHA-256 of every lane of a bucketed message wire.
// Replaces the XLA program of the reference's hash plane
// (cometbft_tpu/ops/sha256.py _sha256_kernel, a lax.scan over _compress):
// blocks (B, 16, L) uint32 big-endian words, lane last, and each lane's
// padded block count nblocks (L,), uint16 or int32 -> state (8, L) uint32.
//
// What bounds it: not the card's integer throughput (1,384 instructions
// a compression at the fewest, ops/cuda_sha256.OPS_PER_BLOCK, against 64
// B read), but SHA-256's serial chain and one warp's issue. A lane's
// compressions depend on each other, and so do the 64 rounds inside one,
// so a launch lasts at least its longest lane's blocks x 64 rounds x the
// round's dependent chain (e: a funnel shift, a LOP3, an add, each ~4.7
// cycles on the H100; a: the same, a round behind). And a warp issues a
// funnel shift, a LOP3 or an IADD3 to the integer pipe and an IMAD to the
// FMA pipe at most every other clock each (chip_smoke.clock_probe): a
// round's six rotations and four LOP3s alone hold the integer pipe 20
// clocks. The path's shapes have few long lanes or short ones: the 336
// part leaves of a 21 MiB block (2,048 x 512: 1,025 blocks each, 11 warps
// of lanes), gossip windows of 2-8 leaves (2,048 x 8: one warp of lanes,
// the same 1,025 blocks) and tx-key windows (64 x 2,048: 33 blocks each,
// 64 warps of lanes). The card is nearly empty in all three: the time is
// what one warp's chain and issue take. The one-thread design issued the
// schedule (a third of its 1,440 instructions a block) and the rounds
// from one warp, all but 145 of them on the integer pipe.
//
// Design: warp specialisation. A CTA holds 32 lanes and two warps, which
// land on two SM sub-partitions and so never share an issue slot:
// - the schedule warp loads each block's 16 words (coalesced: a warp
//   reads 128 consecutive bytes a word), the next block's while it works
//   on this one, expands the message schedule and writes W[t] + K[t] for
//   the whole block into a ring of STAGES block-stages in shared memory,
//   four rounds to a 16-byte word per lane (8 KiB a stage);
// - the round warp runs only the 64 rounds, reading W[t] + K[t] four
//   rounds at a time with one 128-bit load. h + W[t] + K[t] and d + h +
//   W[t] + K[t] come off the chain (h and d are known three rounds
//   ahead), and the new e is one three-way add of that, Sigma1 and Ch:
//   its chain is a funnel shift, a LOP3 and an IADD3. The round's other
//   six additions are written as multiply-adds by `one`, a kernel
//   argument equal to 1 that the compiler cannot fold, so they issue as
//   IMADs on the FMA pipe beside the integer pipe's 11 instructions.
// Stage hand-off: a pair of named barriers a stage (full, empty): the
// schedule warp arrives at full after writing a stage and waits at empty
// before overwriting it; the round warp waits at full and arrives at
// empty once its loads of the stage are done. Two stages measured faster
// than four (kernel_ab.py's probes). Both warps walk to their 32 lanes'
// largest count, clamped to B; a lane past its own count (or a padding
// lane) reads no block (the schedule warp expands zeros) and keeps its
// state, and every lane of the L writes its state, lanes without blocks
// the initial one. The same one round warp per 32 lanes serves every
// shape: the part leaves are 11 CTAs on 11 SMs, a gossip window one, a
// tx-key window 64. Launches go on the caller's stream; nothing
// synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;  // lanes a CTA: one schedule and one round warp
constexpr int THREADS = 2 * LANES;
constexpr int STAGES = 2;  // blocks in flight from the schedule warp
constexpr int QUADS = 16;  // 16-byte words a lane's stage holds: 64 rounds
// named barriers (0 is __syncthreads'): stage s is full at FULL + s and
// empty at EMPTY + s
constexpr int FULL = 1;
constexpr int EMPTY = FULL + STAGES;

__constant__ uint32_t K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

// Named barrier `id` over `threads` threads: bar_sync counts this thread
// and waits until all have arrived; bar_arrive counts it and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// block b's 16 words of this lane, or zeros where the lane has no block b
__device__ __forceinline__ void load_block(uint32_t w[16],
                                           const uint32_t* __restrict__ p,
                                           int b, bool real, size_t lanes) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = real ? __ldg(p + ((size_t)b * 16 + i) * lanes) : 0u;
}

// The schedule warp: W[t] + K[t] of blocks 0..nbmax-1 into the ring.
__device__ __forceinline__ void schedule(uint4* ring,
                                         const uint32_t* __restrict__ p,
                                         int nb, int nbmax, size_t lanes,
                                         int i) {
  uint32_t w[16], next[16];
  load_block(w, p, 0, nb > 0, lanes);
#pragma unroll 1
  for (int b = 0; b < nbmax; ++b) {
    load_block(next, p, b + 1, b + 1 < nb, lanes);
    const int s = b % STAGES;
    if (b >= STAGES) bar_sync(EMPTY + s, THREADS);
    uint4* stage = ring + s * QUADS * LANES + i;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      uint32_t wk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * q + j;
        if (t >= 16) {
          // w[t & 15] holds W[t - 16]
          const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
          w[t & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) +
                       w[(t - 7) & 15] +
                       (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
        }
        wk[j] = w[t & 15] + K[t];
      }
      stage[q * LANES] = make_uint4(wk[0], wk[1], wk[2], wk[3]);
    }
    bar_arrive(FULL + s, THREADS);
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = next[k];
  }
}

// The round warp: the 64 rounds of blocks 0..nbmax-1 from the ring; the
// state of lane `lane` (written when it is one of the L) takes block b
// only where b < nb. x * one + y is x + y on the FMA pipe; the new e is
// a three-way add on the integer pipe, so its chain is three steps.
__device__ __forceinline__ void rounds(const uint4* ring,
                                       uint32_t* __restrict__ state, int nb,
                                       int nbmax, int lanes, int lane, int i,
                                       uint32_t one) {
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
#pragma unroll 1
  for (int b = 0; b < nbmax; ++b) {
    const int s = b % STAGES;
    bar_sync(FULL + s, THREADS);
    const uint4* stage = ring + s * QUADS * LANES + i;
    uint4 quad[QUADS];
#pragma unroll
    for (int q = 0; q < QUADS; ++q) quad[q] = stage[q * LANES];
    // the schedule warp waits for this stage only while it has blocks
    // left to write into it
    if (b + STAGES < nbmax) bar_arrive(EMPTY + s, THREADS);
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      const uint4 qd = quad[t >> 2];
      const uint32_t wk = (t & 3) == 0 ? qd.x
                          : (t & 3) == 1 ? qd.y
                          : (t & 3) == 2 ? qd.z
                                         : qd.w;
      // off the chain: h and d are the e and a of three rounds back
      const uint32_t hk = hh * one + wk;
      const uint32_t dhk = d * one + hk;
      const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint32_t s1ch = s1 * one + ch;
      const uint32_t s0maj = s0 * one + maj;
      hh = g;
      g = f;
      f = e;
      e = dhk + s1 + ch;
      d = c;
      c = bb;
      bb = a;
      a = (s1ch * one + hk) * one + s0maj;
    }
    // a lane past its count keeps its state
    const bool real = b < nb;
    h[0] = real ? h[0] + a : h[0];
    h[1] = real ? h[1] + bb : h[1];
    h[2] = real ? h[2] + c : h[2];
    h[3] = real ? h[3] + d : h[3];
    h[4] = real ? h[4] + e : h[4];
    h[5] = real ? h[5] + f : h[5];
    h[6] = real ? h[6] + g : h[6];
    h[7] = real ? h[7] + hh : h[7];
  }
  if (lane < lanes) {
#pragma unroll
    for (int k = 0; k < 8; ++k) state[(size_t)k * lanes + lane] = h[k];
  }
}

template <typename NB>
__global__ void __launch_bounds__(THREADS)
    x4_sha256(const uint32_t* __restrict__ blocks,
              const NB* __restrict__ nblocks, uint32_t* __restrict__ state,
              int bucket, int lanes, uint32_t one) {
  __shared__ uint4 ring[STAGES * QUADS * LANES];
  const int i = threadIdx.x % LANES;
  const int lane = blockIdx.x * LANES + i;
  int nb = 0;  // this lane's blocks: its count, read as B above B
  if (lane < lanes) {
    const int count = (int)nblocks[lane];
    nb = count < bucket ? count : bucket;
  }
  // both warps walk to the largest count of their 32 lanes
  const int nbmax = (int)__reduce_max_sync(0xffffffffu, (unsigned)nb);
  if (threadIdx.x < LANES)
    schedule(ring, blocks + (lane < lanes ? lane : 0), nb, nbmax,
             (size_t)lanes, i);
  else
    rounds(ring, state, nb, nbmax, lanes, lane, i, one);
}

template <typename NB>
int launch(const uint32_t* blocks, const void* nblocks, uint32_t* state,
           int bucket, int lanes, cudaStream_t stream) {
  const NB* nb = static_cast<const NB*>(nblocks);
  const auto kernel = x4_sha256<NB>;
  kernel<<<(lanes + LANES - 1) / LANES, THREADS, 0, stream>>>(
      blocks, nb, state, bucket, lanes, 1u);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry (ctypes): launches on `stream`, returns the cudaError_t. The
// block counts are uint16 when nb_u16 is 1, else int32; `bucket` is B,
// the blocks each lane has in `blocks`.
extern "C" int sha256_blocks(const uint32_t* blocks, const void* nblocks,
                             int nb_u16, uint32_t* state, int bucket,
                             int lanes, cudaStream_t stream) {
  if (lanes <= 0) return 0;
  return nb_u16
             ? launch<uint16_t>(blocks, nblocks, state, bucket, lanes, stream)
             : launch<int32_t>(blocks, nblocks, state, bucket, lanes, stream);
}
