// X5: the RLC batch equation as one multiscalar multiplication (MSM).
// Replaces cometbft_tpu/ops/rlc.py _rlc_kernel (an XLA program, jitted at
// :229): decompress the folded A points and the pre-negated R points,
// sum each side's points by the host's signed-digit plan (Pippenger with
// sorted segments, ops/rlc.plan_msm), combine the windows msb first, add
// [b]B, and test [8](total) == O with every point decoded. One byte out.
//
// What bounds it: 32-bit multiply-adds in the decompressions and the
// bucket adds (ops/rlc.op_ledger counts them), and, at these sizes as
// much, its serial stages: each window's bucket weighting and the Horner
// walk over the windows are chains of dependent point operations that no
// number of SMs shortens (ops/cuda_rlc.chain_products counts them).
//
// Design, four launches on one stream, every point on fe26.cuh:
// (a) x5_decompress, one thread a point (decompress_xc, as K1 and X1):
//     the affine point in affine-Niels planes (y-x, y+x, 2dxy), and its
//     ok byte. A point that does not decode becomes the identity.
// (b) x5_buckets, one quad a (side, window, bucket v in 1..m): it walks
//     its segment [starts, ends) of the sorted lanes, negating where the
//     plan's sign says (planes 0 and 1 swap, plane 2 flips), with one
//     affine-Niels add a point. The host sorted the lanes, so there is no
//     scatter and no atomic. A warp's eight quads run to the longest of
//     their segments; a quad past its own end keeps its sum.
// (c) x5_chunks, one quad a run of S consecutive buckets of a window: the
//     running sum from the top bucket down gives the run's total C_k and
//     its weighted sum T_k = sum (v - kS) B_v.
// (d) x5_finish, one block: a quad a window joins its runs,
//     W_j = sum_k T_k + [S] sum_k k C_k (the same running sum over the
//     runs, then log2 S doublings); then warp 0 walks Horner over A's
//     windows, warp 1 over R's, warp 2 sums [b]B from K3's paired 8-bit
//     table; warp 0 adds the three, doubles three times and tests X == 0
//     and Y == Z on canonical limbs, ANDed with every ok byte.
// The window sums and the pre-cofactor total stay in `sums`, extended
// coordinates in 26-bit limbs, for the wrapper to hand back on request.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

namespace {

constexpr int BLOCK = 128;
constexpr int FINISH_MAX_THREADS = 512;

// One side of the MSM (0: A, 1: R): its inputs as ops/rlc.plan_msm
// gives them, lane-minor int32, and its shape.
struct Side {
  const int32_t* y;       // (20, n) 13-bit limbs
  const int32_t* sign;    // (n,)
  const int32_t* perm;    // (w, n) lanes in sorted order
  const int32_t* psign;   // (w, n) negate mask, sorted order
  const int32_t* starts;  // (w, m) segment bounds of bucket v = 1..m
  const int32_t* ends;    // (w, m)
  int n, c, w, m, k;      // lanes, window bits, windows, buckets, runs
  int pt0, b0, r0, s0;    // this side's first point, bucket, run, sum
};

struct Args {
  Side side[2];
  const int32_t* b_bytes;  // (32,) little-endian bytes of b
  const int32_t* consts;   // ops/curve.kernel_consts
  const int32_t* tab8;     // ops/cuda_verify._base_table8_26
  uint32_t* pts;           // (points, 3, NL) affine-Niels planes
  uint8_t* okb;            // (points,)
  uint32_t* buckets;       // (buckets, 4, NL) Niels, quad component c
  uint32_t* runs;          // (runs, 2, 4, NL) C_k and T_k, Niels
  uint32_t* sums;          // (wa + wr + 1, 4, NL) extended
  uint8_t* out;            // (1,)
  int s, log2s;            // buckets a run
};

__device__ __forceinline__ fe fe_ld(const uint32_t* p) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = p[i];
  return r;
}

__device__ __forceinline__ void fe_st(uint32_t* p, const fe& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) p[i] = a.v[i];
}

__global__ void __launch_bounds__(BLOCK) x5_decompress(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  stage_consts26(sm, a.consts);
  const int total = a.side[0].n + a.side[1].n;
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= total) return;
  const Side& s = a.side[p < a.side[0].n ? 0 : 1];
  const int ln = p - s.pt0;
  const fe y = fe_load13(s.y + ln, s.n);
  fe x;
  const bool ok = decompress_x(x, y, s.sign[ln], sm);
  const fe xm = fe_select(ok, x, fe_small(0));
  const fe ym = fe_select(ok, y, fe_small(1));
  uint32_t* o = a.pts + (size_t)p * 3 * NL;
  fe_st(o, fe_sub(ym, xm));
  fe_st(o + NL, fe_add(ym, xm));
  fe_st(o + 2 * NL, fe_mul(fe_mul(xm, ym), fe_const(sm + C_D2)));
  a.okb[p] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(BLOCK) x5_buckets(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  stage_consts26(sm, a.consts);
  const int c = quad_c();
  const int q = (blockIdx.x * BLOCK + threadIdx.x) >> 2;
  const int nb0 = a.side[0].w * a.side[0].m;
  // every side's bucket count is a multiple of 8 (m >= 8), so a warp is
  // whole inside one side, and one past the last bucket leaves whole
  if (q >= nb0 + a.side[1].w * a.side[1].m) return;
  const Side& s = a.side[q < nb0 ? 0 : 1];
  const int b = q - s.b0;  // j * m + (v - 1)
  const int j = b / s.m;
  const int lo = s.starts[b];
  const int len = s.ends[b] - lo;
  const int most = (int)__reduce_max_sync(0xffffffffu, (unsigned)len);
  const int32_t* perm = s.perm + (size_t)j * s.n + lo;
  const int32_t* psign = s.psign + (size_t)j * s.n + lo;
  // thread c's plane of a point, (y-x, y+x, -, 2dxy); a negated point
  // (-x, y) swaps the first two and negates the third
  fe acc = q_identity(c);
#pragma unroll 1
  for (int t = 0; t < most; ++t) {
    const bool take = t < len;
    const int lane = take ? perm[t] : 0;
    const bool negate = take && psign[t] != 0;
    const int plane = c == 3 ? 2 : (c ^ (negate ? 1 : 0));
    const fe e = fe_ld(a.pts + ((size_t)(s.pt0 + lane) * 3 + plane) * NL);
    const fe n = fe_select(c == 2, fe_small(2),
                           fe_select(c == 3 && negate, fe_neg(e), e));
    const fe next = q_add(acc, n, c);
    acc = fe_select(take, next, acc);
  }
  fe_st(a.buckets + ((size_t)q * 4 + c) * NL,
        q_to_niels(acc, fe_const(sm + C_D2), c));
}

__global__ void __launch_bounds__(BLOCK) x5_chunks(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  stage_consts26(sm, a.consts);
  const int c = quad_c();
  const int q = (blockIdx.x * BLOCK + threadIdx.x) >> 2;
  const int nr0 = a.side[0].w * a.side[0].k;
  const int nq = nr0 + a.side[1].w * a.side[1].k;
  // a warp may straddle the sides or the end: every quad runs S turns,
  // and one past the end works on the last run and stores nothing
  const bool live = q < nq;
  const int qq = live ? q : nq - 1;
  const Side& s = a.side[qq < nr0 ? 0 : 1];
  const int r = qq - s.r0;  // j * k + run
  const int j = r / s.k;
  const uint32_t* bk =
      a.buckets + ((size_t)s.b0 + (size_t)j * s.m + (size_t)(r % s.k) * a.s) *
                      4 * NL;
  const fe d2 = fe_const(sm + C_D2);
  fe run = q_identity(c);
  fe tot = q_identity(c);
#pragma unroll 1
  for (int t = a.s - 1; t >= 0; --t) {
    run = q_add(run, fe_ld(bk + ((size_t)t * 4 + c) * NL), c);
    tot = q_add(tot, q_to_niels(run, d2, c), c);
  }
  const fe cn = q_to_niels(run, d2, c);
  const fe tn = q_to_niels(tot, d2, c);
  if (live) {
    fe_st(a.runs + (((size_t)q * 2 + 0) * 4 + c) * NL, cn);
    fe_st(a.runs + (((size_t)q * 2 + 1) * 4 + c) * NL, tn);
  }
}

__global__ void __launch_bounds__(FINISH_MAX_THREADS) x5_finish(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t part[3][4][NL];  // Horner A, Horner R, [b]B
  __shared__ int bad;
  stage_consts26(sm, a.consts);
  const int c = quad_c();
  const int warp = threadIdx.x >> 5;
  const fe d2 = fe_const(sm + C_D2);
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < a.side[0].n + a.side[1].n; p += blockDim.x)
    if (a.okb[p] == 0) bad = 1;

  // each side's windows on warps of their own (the run counts differ)
  {
    const int warps_a = (a.side[0].w + 7) / 8;
    const int sd = warp < warps_a ? 0 : 1;
    const Side& s = a.side[sd];
    const int j0 = ((threadIdx.x >> 2) - (sd ? warps_a * 8 : 0));
    const bool live = j0 < s.w;
    const int j = live ? j0 : s.w - 1;
    const uint32_t* rk = a.runs + ((size_t)s.r0 + (size_t)j * s.k) * 2 * 4 * NL;
    fe run = q_identity(c);
    fe acc = q_identity(c);
    fe tsum = q_identity(c);
#pragma unroll 1
    for (int k = s.k - 1; k >= 0; --k) {
      const uint32_t* e = rk + (size_t)k * 2 * 4 * NL;
      tsum = q_add(tsum, fe_ld(e + (4 + c) * NL), c);
      if (k >= 1) {
        run = q_add(run, fe_ld(e + c * NL), c);
        acc = q_add(acc, q_to_niels(run, d2, c), c);
      }
    }
#pragma unroll 1
    for (int i = 0; i < a.log2s; ++i) acc = q_double(acc, c);
    acc = q_add(acc, q_to_niels(tsum, d2, c), c);
    if (live) fe_st(a.sums + ((size_t)(s.s0 + j) * 4 + c) * NL, acc);
  }
  __syncthreads();

  if (warp < 2) {  // Horner over one side's windows, msb first
    const Side& s = a.side[warp];
    const uint32_t* ws = a.sums + (size_t)s.s0 * 4 * NL;
    fe acc = fe_ld(ws + ((size_t)(s.w - 1) * 4 + c) * NL);
#pragma unroll 1
    for (int j = s.w - 2; j >= 0; --j) {
#pragma unroll 1
      for (int i = 0; i < s.c; ++i) acc = q_double(acc, c);
      acc = q_add(acc, q_to_niels(fe_ld(ws + ((size_t)j * 4 + c) * NL), d2, c),
                  c);
    }
    if ((threadIdx.x & 31) < 4) fe_st(part[warp][c], acc);
  } else if (warp == 2) {
    const fe sb = q_fixed_base8(a.tab8, a.b_bytes, 1, 0, c);
    if ((threadIdx.x & 31) < 4) fe_st(part[2][c], sb);
  }
  __syncthreads();

  if (warp == 0) {
    fe t = fe_ld(part[2][c]);
    t = q_add(t, q_to_niels(fe_ld(part[0][c]), d2, c), c);
    t = q_add(t, q_to_niels(fe_ld(part[1][c]), d2, c), c);
    const int wt = a.side[0].w + a.side[1].w;
    if (threadIdx.x < 4) fe_st(a.sums + ((size_t)wt * 4 + c) * NL, t);
#pragma unroll 1
    for (int i = 0; i < 3; ++i) t = q_double(t, c);  // the cofactor
    const fe x = fe_shfl(t, 0);
    const fe y = fe_shfl(t, 1);
    const fe z = fe_shfl(t, 2);
    const bool ident = fe_is_zero(x) && fe_is_zero(fe_sub(y, z));
    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
  }
}

// Args from the C entries' arrays. p: y, sign, perm, psign, starts,
// ends of A, the same of R, then b_bytes, consts, tab8, pts, okb,
// buckets, runs, sums, out. iv: n, c, w of A, the same of R, then S
// (buckets a run, a power of two dividing both sides' m). Returns the
// stages' grids.
void setup(Args& a, void* const* p, const int* iv, int grid[4]) {
  int pt = 0, bk = 0, rn = 0, sm = 0;
  for (int sd = 0; sd < 2; ++sd) {
    Side& s = a.side[sd];
    s.y = (const int32_t*)p[6 * sd + 0];
    s.sign = (const int32_t*)p[6 * sd + 1];
    s.perm = (const int32_t*)p[6 * sd + 2];
    s.psign = (const int32_t*)p[6 * sd + 3];
    s.starts = (const int32_t*)p[6 * sd + 4];
    s.ends = (const int32_t*)p[6 * sd + 5];
    s.n = iv[3 * sd + 0];
    s.c = iv[3 * sd + 1];
    s.w = iv[3 * sd + 2];
    s.m = 1 << (s.c - 1);
    s.k = s.m / iv[6];
    s.pt0 = pt;
    s.b0 = bk;
    s.r0 = rn;
    s.s0 = sm;
    pt += s.n;
    bk += s.w * s.m;
    rn += s.w * s.k;
    sm += s.w;
  }
  a.b_bytes = (const int32_t*)p[12];
  a.consts = (const int32_t*)p[13];
  a.tab8 = (const int32_t*)p[14];
  a.pts = (uint32_t*)p[15];
  a.okb = (uint8_t*)p[16];
  a.buckets = (uint32_t*)p[17];
  a.runs = (uint32_t*)p[18];
  a.sums = (uint32_t*)p[19];
  a.out = (uint8_t*)p[20];
  a.s = iv[6];
  a.log2s = 0;
  while ((1 << a.log2s) < a.s) ++a.log2s;
  int warps = (a.side[0].w + 7) / 8 + (a.side[1].w + 7) / 8;
  grid[0] = (pt + BLOCK - 1) / BLOCK;
  grid[1] = (4 * bk + BLOCK - 1) / BLOCK;
  grid[2] = (4 * rn + BLOCK - 1) / BLOCK;
  grid[3] = 32 * (warps < 3 ? 3 : warps);  // x5_finish's threads
}

int launch(const Args& a, const int grid[4], int stage,
           cudaStream_t stream) {
  if (grid[3] > FINISH_MAX_THREADS) return 1;  // cudaErrorInvalidValue
  const int threads = grid[3];
  switch (stage) {
    case 0:
      x5_decompress<<<grid[0], BLOCK, 0, stream>>>(a);
      break;
    case 1:
      x5_buckets<<<grid[1], BLOCK, 0, stream>>>(a);
      break;
    case 2:
      x5_chunks<<<grid[2], BLOCK, 0, stream>>>(a);
      break;
    default:
      x5_finish<<<1, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry (ctypes): launches stage `stage` of X5 (0-3: decompress,
// buckets, runs, finish) on `stream` and returns its cudaError_t (the
// arrays as setup reads them); the four in order are one X5 run.
extern "C" int x5_rlc_stage(void* const* p, const int* iv, int stage,
                            cudaStream_t stream) {
  Args a;
  int grid[4];
  setup(a, p, iv, grid);
  return launch(a, grid, stage, stream);
}
