// X4 x4_sha256: SHA-256 of every lane of a bucketed message wire.
// Replaces the XLA program of the reference's hash plane
// (cometbft_tpu/ops/sha256.py _sha256_kernel, a lax.scan over _compress):
// blocks (B, 16, L) uint32 big-endian words, lane last, and each lane's
// padded block count nblocks (L,), uint16 or int32 -> state (8, L) uint32.
//
// What bounds it: 32-bit integer operations, 1,384 a compression at the
// fewest (ops/cuda_sha256.OPS_PER_BLOCK) against 64 B read, so the work is
// far above the card's operations-per-byte line. But SHA-256 is serial
// within a message: a lane's compressions depend on each other, and so
// do the 64 rounds inside one. With few long lanes (a 21 MiB block's 336
// parts of 1,025 blocks each, 11 warps on 132 SMs) the launch is bound by
// that chain's latency, far from the operations bound; windows of
// thousands of short lanes fill the card better.
//
// Design: one thread a lane, each walking its own block count (never
// the bucket B, which may be twice the longest lane; a count above B is
// read as B, as the reference's scan over B blocks does). Word w of block b
// sits at blocks[(b * 16 + w) * L + lane], so a warp reads 128
// consecutive bytes per word. The next block's 16 words load while the
// current one compresses. The round constants live in __constant__
// memory, read at a uniform index. The 64 rounds and the 16-word
// schedule ring are fully unrolled, so every ring index is a constant and
// the ring stays in registers; rotations are funnel shifts. Every one of
// the L lanes writes its state, lanes without blocks the initial one.
// Launches go on the caller's stream; nothing synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;

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

// one compression of `w` (the ring, overwritten) into the state `h`
__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt = w[t & 15];
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt += s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        ((e & f) ^ (~e & g)) + K[t] + wt;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

__device__ __forceinline__ void load_block(uint32_t w[16],
                                           const uint32_t* __restrict__ p,
                                           int b, size_t lanes) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = __ldg(p + ((size_t)b * 16 + i) * lanes);
}

template <typename NB>
__global__ void __launch_bounds__(BLOCK)
    x4_sha256(const uint32_t* __restrict__ blocks,
              const NB* __restrict__ nblocks, uint32_t* __restrict__ state,
              int bucket, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  const int count = (int)nblocks[lane];
  const int nb = count < bucket ? count : bucket;
  const uint32_t* p = blocks + lane;
  uint32_t w[16];
  if (nb > 0) load_block(w, p, 0, (size_t)lanes);
  for (int b = 0; b < nb; ++b) {
    // the next block (the current one again at the end: no branch)
    uint32_t next[16];
    load_block(next, p, b + 1 < nb ? b + 1 : b, (size_t)lanes);
    compress(h, w);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = next[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) state[(size_t)i * lanes + lane] = h[i];
}

template <typename NB>
int launch(const uint32_t* blocks, const void* nblocks, uint32_t* state,
           int bucket, int lanes, cudaStream_t stream) {
  const NB* nb = static_cast<const NB*>(nblocks);
  x4_sha256<NB><<<(lanes + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      blocks, nb, state, bucket, lanes);
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
