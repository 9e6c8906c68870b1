// X5: the RLC batch equation as one multiscalar multiplication (MSM).
// Replaces cometbft_tpu/ops/rlc.py _rlc_kernel (an XLA program, jitted at
// :229): decompress the folded A points and the pre-negated R points,
// sum each side's points by the host's signed-digit plan (Pippenger with
// sorted segments, ops/rlc.plan_msm), combine the windows msb first, add
// [b]B, and test [8](total) == O with every point decoded. One byte out.
//
// What bounds it on the H100: the 64-bit multiply-adds (IMAD.WIDE.U32) of
// the field products, which one warp issues at several cycles each, so
// a point operation on a quad (four threads, one product each a round)
// costs one warp ~1,000 cycles a round. The parallel stages, the
// decompressions and the bucket adds, have the SMs' issue to themselves
// (ops/cuda_rlc.work counts them); the serial ones, each window's join
// of its runs and the Horner walk over the windows (253 doublings on A's
// side), are chains of dependent point operations that no number of SMs
// shortens (chip_smoke.chain_products counts them). Those run on the
// warp ops below: a point a warp, each product's 100 limb products split
// over eight lanes, 14 multiply-adds and 29 shuffles a lane where a
// quad's thread issues 100 multiply-adds (on an H100 a doubling costs one
// warp ~1,300 cycles this way, ~2,050 on a quad).
//
// Design, six launches on one stream, every point on fe26.cuh:
// (a) x5_decompress, one thread a point (decompress_xc, as K1 and X1):
//     the affine point in affine-Niels planes (y-x, y+x, 2dxy); a point
//     that does not decode becomes the identity. A lane whose encoding is
//     the identity's (y = 1, sign 0), which every pad lane is, is the
//     identity without the sqrt chain, so the pad warps at the end of
//     each side skip it. Each block writes one byte: all its points
//     decoded.
// (b) x5_buckets, one quad a (side, window, bucket v in 1..m): it walks
//     its segment [starts, ends) of the sorted lanes, negating where the
//     plan's sign says (planes 0 and 1 swap, plane 2 flips), with one
//     affine-Niels add a point; the next point's planes load while the
//     current one adds. The host sorted the lanes, so there is no
//     scatter and no atomic. A warp's eight quads run to the longest of
//     their segments; a quad past its own end keeps its sum. A window
//     whose digits fill only buckets 1..m / P (a side's top window: R's
//     128-bit scalars leave it 7 or 8 bits) walks each of those buckets
//     on P quads and joins their parts in a tree.
// (c) x5_runs, one quad a run of S consecutive buckets of a window: the
//     running sum from the top bucket down gives the run's total C_k and
//     its weighted sum T_k = sum (v - kS) B_v.
// (d) x5_groups, two warps a group of F consecutive runs: the same
//     (C, T) of the group's F S buckets (combine).
// (e) x5_join, two warps a window: W_j = sum_v v B_v from its groups
//     (combine); two more warps sum [b]B from K3's paired 8-bit table.
// (f) x5_finish, two warps: the window sums staged in shared memory,
//     warp 0 walks Horner over A's windows and warp 1 over R's; warp 0
//     adds the two and [b]B, doubles three times and tests X == 0 and
//     Y == Z on canonical limbs, ANDed with every block's ok byte.
// Stages (a)-(c) keep the SMs busy; (d)-(f) are the chains, on the warp
// ops: three levels of sums (S, F and the groups of a window) keep each
// of them short.
// The window sums, the pre-cofactor total and [b]B stay in `sums`,
// extended coordinates in 26-bit limbs, for the wrapper to hand back on
// request.
#include <cuda_runtime.h>

#include "fe26.cuh"

using namespace f26;

namespace {

constexpr int BLOCK = 128;
constexpr int COMBINE_THREADS = 64;  // x5_groups, x5_join: two warps
constexpr int FINISH_THREADS = 64;  // x5_finish: Horner A, Horner R
constexpr int MAX_SUMS = 100;       // window sums, total, [b]B (c >= 4)
constexpr uint32_t FULL = 0xffffffffu;

// One side of the MSM (0: A, 1: R): its inputs as ops/rlc.plan_msm
// gives them, lane-minor int32, and its shape.
struct Side {
  const int32_t* y;       // (20, n) 13-bit limbs
  const int32_t* sign;    // (n,)
  const int32_t* perm;    // (w, n) lanes in sorted order
  const int32_t* psign;   // (w, n) negate mask, sorted order
  const int32_t* starts;  // (w, m) segment bounds of bucket v = 1..m
  const int32_t* ends;    // (w, m)
  int n, c, w, m, k, g;   // lanes, window bits, windows; a window's
                          // buckets, runs, groups
  int pt0, b0, r0, g0, s0;  // this side's first point, bucket, run,
                            // group, sum
};

struct Args {
  Side side[2];
  const int32_t* b_bytes;  // (32,) little-endian bytes of b
  const int32_t* consts;   // ops/curve.kernel_consts
  const int32_t* tab8;     // ops/cuda_verify._base_table8_26
  uint32_t* pts;           // (points, 3, NL) affine-Niels planes
  uint8_t* okb;            // (x5_decompress's blocks,) all decoded
  uint32_t* buckets;       // (buckets, 4, NL) Niels, quad component c
  uint32_t* runs;          // (runs, 2, 4, NL) C_k and T_k, Niels
  uint32_t* groups;        // (groups, 2, 4, NL) the same of F runs
  uint32_t* sums;          // (wa + wr + 2, 4, NL) extended: the window
                           // sums, the pre-cofactor total, [b]B
  uint8_t* out;            // (1,)
  int s, log2s;            // buckets a run
  int f, log2f;            // runs a group
  int nokb;                // ok bytes
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

// ---------------------------------------------------------- a warp a point
// Lane 8c + s of a warp holds coordinate c of one point (or component c
// of its Niels form) spread over the coordinate's eight lanes: limb s in
// `lo` and, on lanes 0 and 1, limb s + 8 in `hi` (a don't-care on lanes
// 2-7). The formulas are fe26.cuh's quad ops (q_double, q_add,
// q_to_niels) limb for limb: an add or a subtraction is two words a lane,
// carry1 one shuffle from the lane below, a move between coordinates two
// shuffles, and a field product (d_mul) splits fe_mul's 100 limb products
// over the eight lanes. Each op gives fe26.cuh's limbs exactly, so its
// bounds hold as they are.

struct fd {
  uint32_t lo, hi;
};

__device__ __forceinline__ int w_c() { return (threadIdx.x >> 3) & 3; }
__device__ __forceinline__ int w_s() { return threadIdx.x & 7; }

constexpr uint32_t BIAS_HI = (1u << 28) - 4;  // bias(8), bias(9)

__device__ __forceinline__ uint32_t shfl8(uint32_t v, int src) {
  return __shfl_sync(FULL, v, src, 8);
}

__device__ __forceinline__ fd d_small(uint32_t v0) {
  return fd{w_s() == 0 ? v0 : 0u, 0u};
}

__device__ __forceinline__ fd d_select(bool take_a, const fd& a,
                                       const fd& b) {
  return fd{take_a ? a.lo : b.lo, take_a ? a.hi : b.hi};
}

// This lane's limbs of a 10-limb element at p.
__device__ __forceinline__ fd d_ld(const uint32_t* p) {
  const int s = w_s();
  return fd{p[s], s < 2 ? p[s + 8] : 0u};
}

__device__ __forceinline__ void d_st(uint32_t* p, const fd& a) {
  const int s = w_s();
  p[s] = a.lo;
  if (s < 2) p[s + 8] = a.hi;
}

// carry1: every limb's bits above 26 to the limb above, limb 9's times
// 608 to limb 0.
__device__ __forceinline__ fd d_carry(const fd& x) {
  const int s = w_s();
  const uint32_t cl = shfl8(x.lo >> BITS, (s - 1) & 7);  // limb s - 1's
  const uint32_t ch = shfl8(x.hi >> BITS, s ^ 1);        // limb 9 or 8's
  return fd{(x.lo & MASK) + (s == 0 ? ch * FOLD : cl),
            (x.hi & MASK) + (s == 0 ? cl : ch)};
}

__device__ __forceinline__ fd d_add(const fd& a, const fd& b) {
  return d_carry(fd{a.lo + b.lo, a.hi + b.hi});
}

// The 10 limbs of this lane's coordinate, on every lane of it.
__device__ __forceinline__ fe d_gather(const fd& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = shfl8(a.lo, i);
  r.v[8] = shfl8(a.hi, 0);
  r.v[9] = shfl8(a.hi, 1);
  return r;
}

// fold_cols on columns held by column: lane s has columns s, s + 8 and
// s + 16 (c16 on lanes 0-2), and gets limb s (and limb s + 8 on lanes
// 0-1) of fe_mul's result. t_i = c_i + 608 lo26(c_{i+10}) (i <= 8) +
// 608 (c_{i+9} >> 26) (i >= 1), then the two carry passes, each one
// shuffle from the lane below.
__device__ __forceinline__ fd d_fold(uint64_t c0, uint64_t c8,
                                     uint64_t c16) {
  const int s = w_s();
  const uint32_t x_lo = shfl8((uint32_t)(s >= 2 ? c8 : c16) & MASK,
                              (s + 2) & 7);
  const uint32_t y_hi = shfl8((uint32_t)((s >= 1 ? c8 : c16) >> BITS),
                              (s + 1) & 7);
  const uint32_t z_lo = shfl8((uint32_t)c16 & MASK, (s + 2) & 7);
  const uint32_t w_hi = shfl8((uint32_t)(c16 >> BITS), (s + 1) & 7);
  // tl is limb s's t, th limb s + 8's (lanes 0-1)
  const uint64_t tl = c0 + (uint64_t)x_lo * FOLD +
                      (s >= 1 ? (uint64_t)y_hi * FOLD : 0);
  const uint64_t th = s >= 2 ? 0
                             : c8 + (s == 0 ? (uint64_t)z_lo * FOLD : 0) +
                                   (uint64_t)w_hi * FOLD;
  // pass 1: r_i = lo26(t_i) + (t_{i-1} >> 26), r_0 = lo26(t_0) +
  // (t_9 >> 26) 608 in 64 bits
  const uint32_t p1 = shfl8((uint32_t)(tl >> BITS), (s - 1) & 7);
  const uint32_t p2 = shfl8((uint32_t)(th >> BITS), s ^ 1);
  const uint32_t rl = ((uint32_t)tl & MASK) + p1;
  const uint64_t r0 = (uint64_t)((uint32_t)tl & MASK) + (uint64_t)p2 * FOLD;
  const uint32_t rh = ((uint32_t)th & MASK) + (s == 0 ? p1 : p2);
  // pass 2: o_0 = lo26(r_0) + (r_9 >> 26) 608, o_1 = lo26(r_1) +
  // (r_0 >> 26), o_i = lo26(r_i) + (r_{i-1} >> 26)
  const uint32_t q1 = shfl8(s == 0 ? (uint32_t)(r0 >> BITS) : (rl >> BITS),
                            (s - 1) & 7);
  const uint32_t q2 = shfl8(rh >> BITS, s ^ 1);
  return fd{s == 0 ? ((uint32_t)r0 & MASK) + q2 * FOLD : (rl & MASK) + q1,
            (rh & MASK) + (s == 0 ? q1 : q2)};
}

// a * b, fe_mul's limbs. Lane s owns columns s, s + 8 and s + 16 and
// takes their limb products itself, 14 multiply-adds, the 100 among the
// eight lanes: with all of a on every lane, a_d b_{(s-d) & 7} for d = 0..7
// (b's low limb of lane s - d, column s or, wrapped, s + 8) and a_{d+8}
// times it for d = 0, 1; then a_s b_8 and a_{s+8} b_8, a_{s-1} b_9 and
// a_{s+7} b_9 where those land on its columns.
__device__ __forceinline__ fd d_mul(const fd& a, const fd& b) {
  const int s = w_s();
  const fe aa = d_gather(a);
  const uint32_t b8 = shfl8(b.hi, 0);
  const uint32_t b9 = shfl8(b.hi, 1);
  const uint32_t am1 = shfl8(a.lo, (s - 1) & 7);  // a_{s-1}; lane 0: a_7
  const uint32_t ah1 = shfl8(a.hi, (s - 1) & 7);  // lanes 1, 2: a_8, a_9
  uint64_t c0 = 0, c8 = 0, c16 = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const uint32_t bj = d == 0 ? b.lo : shfl8(b.lo, (s - d) & 7);
    const uint64_t p = (uint64_t)aa.v[d] * bj;
    const bool up = s >= d;
    c0 += up ? p : 0;
    c8 += up ? 0 : p;
    if (d < 2) {
      const uint64_t p8 = (uint64_t)aa.v[d + 8] * bj;
      c8 += up ? p8 : 0;
      c16 += up ? 0 : p8;
    }
  }
  c8 += (uint64_t)a.lo * b8;
  c16 += (uint64_t)(s < 2 ? a.hi : 0u) * b8;
  const uint64_t p9 = (uint64_t)am1 * b9;
  c8 += s >= 1 ? p9 : 0;
  c16 += (s == 0 ? p9 : 0) + (uint64_t)(s == 1 || s == 2 ? ah1 : 0u) * b9;
  return d_fold(c0, c8, c16);
}

// Coordinate src's element (fe_shfl of a quad).
__device__ __forceinline__ fd d_shfl(const fd& a, int src) {
  const int from = (src << 3) | w_s();
  return fd{__shfl_sync(FULL, a.lo, from, 32),
            __shfl_sync(FULL, a.hi, from, 32)};
}

// Coordinate c ^ 1's element (fe_shfl_xor1 of a quad).
__device__ __forceinline__ fd d_xor1(const fd& a) {
  return fd{__shfl_xor_sync(FULL, a.lo, 8, 32),
            __shfl_xor_sync(FULL, a.hi, 8, 32)};
}

__device__ __forceinline__ fd d_identity(int c) {
  return d_small(c == 1 || c == 2 ? 1 : 0);
}

// [2]P: q_double on the warp.
__device__ __forceinline__ fd w_double(const fd& p, int c) {
  const uint32_t bl = bias(w_s());
  const fd x = d_shfl(p, 0);
  const fd y = d_shfl(p, 1);
  const fd v0 = d_select(c == 3, d_add(x, y), p);
  const fd sq = d_mul(v0, v0);
  const fd s1 = d_shfl(sq, 0);
  const fd s2 = d_shfl(sq, 1);
  const bool minus_s2 = c == 1 || c == 2;
  fd w;
  w.lo = s1.lo + (minus_s2 ? bl - s2.lo : s2.lo) + (c == 2 ? sq.lo << 1 : 0) +
         (c == 3 ? bl - sq.lo : 0);
  w.hi = s1.hi + (minus_s2 ? BIAS_HI - s2.hi : s2.hi) +
         (c == 2 ? sq.hi << 1 : 0) + (c == 3 ? BIAS_HI - sq.hi : 0);
  w = d_carry(w);
  const fd u = d_shfl(w, (c & 1) ? 0 : 2);
  const fd v = d_shfl(w, (c == 0 || c == 3) ? 3 : 1);
  return d_mul(u, v);
}

// P + Q with Q in Niels form, component c of it in n: q_add on the warp.
__device__ __forceinline__ fd w_add(const fd& p, const fd& n, int c) {
  const uint32_t bl = bias(w_s());
  const fd q = d_xor1(p);
  fd w;
  w.lo = c == 0 ? q.lo + bl - p.lo : (c == 1 ? p.lo + q.lo : p.lo);
  w.hi = c == 0 ? q.hi + BIAS_HI - p.hi : (c == 1 ? p.hi + q.hi : p.hi);
  const fd r = d_mul(d_carry(w), n);
  const fd o = d_xor1(r);
  w.lo = c == 0 ? o.lo + bl - r.lo : (c == 2 ? r.lo + bl - o.lo : r.lo + o.lo);
  w.hi = c == 0 ? o.hi + BIAS_HI - r.hi
                : (c == 2 ? r.hi + BIAS_HI - o.hi : r.hi + o.hi);
  w = d_carry(w);
  const fd u = d_shfl(w, c == 1 ? 3 : (c == 3 ? 0 : c));
  const fd v = d_shfl(w, c == 0 ? 2 : (c == 2 ? 3 : 1));
  return d_mul(u, v);
}

// Component c of the Niels form of P: q_to_niels on the warp.
__device__ __forceinline__ fd w_to_niels(const fd& p, const fd& d2, int c) {
  const uint32_t bl = bias(w_s());
  const fd q = d_xor1(p);
  fd w;
  w.lo = c == 0 ? q.lo + bl - p.lo
                : (c == 3 ? p.lo : p.lo + (c == 1 ? q.lo : p.lo));
  w.hi = c == 0 ? q.hi + BIAS_HI - p.hi
                : (c == 3 ? p.hi : p.hi + (c == 1 ? q.hi : p.hi));
  return d_mul(d_carry(w), d_select(c == 3, d2, d_small(1)));
}

// [b]B over windows [j0, j1) of K3's paired 8-bit table: q_fixed_base8
// on the warp.
__device__ __forceinline__ fd w_fixed_base8(const int32_t* __restrict__ tab8,
                                            const int32_t* b_bytes, int j0,
                                            int j1, int c) {
  const int tplane = c == 0 ? 1 : (c == 1 ? 0 : 2);
  fd sb = d_identity(c);
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    const int v = b_bytes[j] & 255;
    const uint32_t* e = reinterpret_cast<const uint32_t*>(
        tab8 + ((size_t)j * 256 + v) * ENTRY8 + tplane * NL);
    sb = w_add(sb, d_select(c == 2, d_small(2), d_ld(e)), c);
  }
  return sb;
}

// ------------------------------------------------------------- the stages

// Thread t of x5_decompress's block `blk` (its blocks cover both sides'
// points in order, A's first): point blk * BLOCK + t, and the block's ok
// byte.
__device__ __forceinline__ void decompress_block(const Args& a, int blk,
                                                 const uint32_t* sm,
                                                 int* all_ok) {
  const int total = a.side[0].n + a.side[1].n;
  const int p = blk * BLOCK + threadIdx.x;
  bool ok = true;
  if (p < total) {
    const Side& s = a.side[p < a.side[0].n ? 0 : 1];
    const int ln = p - s.pt0;
    const fe y = fe_load13(s.y + ln, s.n);
    const int32_t sign = s.sign[ln];
    bool ident = sign == 0 && y.v[0] == 1;
#pragma unroll
    for (int i = 1; i < NL; ++i) ident = ident && y.v[i] == 0;
    uint32_t* o = a.pts + (size_t)p * 3 * NL;
    if (ident) {  // (0, 1): planes (1, 1, 0)
      fe_st(o, fe_small(1));
      fe_st(o + NL, fe_small(1));
      fe_st(o + 2 * NL, fe_small(0));
    } else {
      fe x;
      ok = decompress_x(x, y, sign, sm);
      const fe xm = fe_select(ok, x, fe_small(0));
      const fe ym = fe_select(ok, y, fe_small(1));
      fe_st(o, fe_sub(ym, xm));
      fe_st(o + NL, fe_add(ym, xm));
      fe_st(o + 2 * NL, fe_mul(fe_mul(xm, ym), fe_const(sm + C_D2)));
    }
  }
  if (!ok) *all_ok = 0;
  __syncthreads();
  if (threadIdx.x == 0) a.okb[blk] = (uint8_t)*all_ok;
}

// Quad q (of both sides' buckets in order, A's first) of x5_buckets.
__device__ __forceinline__ void bucket_quad(const Args& a, int q,
                                            const uint32_t* sm) {
  const int c = quad_c();
  const int nb0 = a.side[0].w * a.side[0].m;
  const Side& s = a.side[q < nb0 ? 0 : 1];
  const int b = q - s.b0;  // j * m + index in the window
  const int j = b / s.m;
  const int idx = b - j * s.m;
  const int32_t* starts = s.starts + (size_t)j * s.m;
  const int32_t* ends = s.ends + (size_t)j * s.m;
  // a window whose digits all fall in buckets 1..m / P (P = 8, 4, 2; a
  // top window of few bits) gives each of those buckets P quads, each a
  // part of its segment, so that its long segments walk in parallel; the
  // other quads write the empty buckets
  const int last = ends[s.m - 1];
  int split = 1;
#pragma unroll
  for (int f = 8; f > 1; f >>= 1)
    if (split == 1 && ends[s.m / f - 1] == last) split = f;
  const int v = idx / split;  // v - 1, in fact
  const int part = idx - v * split;
  const int seg = starts[v];
  const int seg_len = ends[v] - seg;
  const int lo = seg + seg_len * part / split;
  const int len = seg + seg_len * (part + 1) / split - lo;
  const int most = (int)__reduce_max_sync(FULL, (unsigned)len);
  const int32_t* perm = s.perm + (size_t)j * s.n + lo;
  const int32_t* psign = s.psign + (size_t)j * s.n + lo;
  const uint32_t* pts = a.pts + (size_t)s.pt0 * 3 * NL;
  // thread c's plane of a point, (y-x, y+x, -, 2dxy); a negated point
  // (-x, y) swaps the first two and negates the third
  auto plane = [&](int lane, bool negate) {
    const int pl = c == 3 ? 2 : (c ^ (negate ? 1 : 0));
    return fe_ld(pts + ((size_t)lane * 3 + pl) * NL);
  };
  // the point of turn t + 1 loads while turn t adds, its lane and sign
  // one turn before that
  int lane2 = len > 1 ? perm[1] : 0;
  bool neg2 = len > 1 && psign[1] != 0;
  bool neg1 = len > 0 && psign[0] != 0;
  fe e1 = plane(len > 0 ? perm[0] : 0, neg1);
  fe acc = q_identity(c);
#pragma unroll 1
  for (int t = 0; t < most; ++t) {
    const bool take = t < len;
    const bool negate = neg1;
    const fe e = e1;
    e1 = plane(lane2, neg2);
    neg1 = neg2;
    const bool more = t + 2 < len;
    lane2 = more ? perm[t + 2] : 0;
    neg2 = more && psign[t + 2] != 0;
    const fe n = fe_select(c == 2, fe_small(2),
                           fe_select(c == 3 && negate, fe_neg(e), e));
    const fe next = q_add(acc, n, c);
    acc = fe_select(take, next, acc);
  }
  const fe d2 = fe_const(sm + C_D2);
  // a split bucket's parts join in a tree of quads (split is alike across
  // the warp): part p takes part p + w's sum
#pragma unroll 1
  for (int w = 1; w < split; w <<= 1) {
    fe other;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      other.v[i] = __shfl_xor_sync(FULL, acc.v[i], 4 * w, 32);
    const fe sum = q_add(acc, q_to_niels(other, d2, c), c);
    acc = fe_select((part & (2 * w - 1)) == 0, sum, acc);
  }
  // part 0 writes its bucket; part p >= 1 of bucket v the empty bucket
  // m / P + v (P - 1) + p - 1
  const int slot = part == 0 ? v : s.m / split + v * (split - 1) + part - 1;
  fe_st(a.buckets + ((size_t)s.b0 + (size_t)j * s.m + slot) * 4 * NL + c * NL,
        q_to_niels(part == 0 ? acc : q_identity(c), d2, c));
}


__global__ void __launch_bounds__(BLOCK) x5_decompress(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ int all_ok;
  if (threadIdx.x == 0) all_ok = 1;
  stage_consts26(sm, a.consts);
  decompress_block(a, blockIdx.x, sm, &all_ok);
}

__global__ void __launch_bounds__(BLOCK) x5_buckets(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  stage_consts26(sm, a.consts);
  const int q = (blockIdx.x * BLOCK + threadIdx.x) >> 2;
  // every side's bucket count is a multiple of 8 (m >= 8), so a warp is
  // whole inside one window, and one past the last bucket leaves whole
  if (q < a.side[0].w * a.side[0].m + a.side[1].w * a.side[1].m)
    bucket_quad(a, q, sm);
}

__global__ void __launch_bounds__(BLOCK) x5_runs(Args a) {
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
  // the next bucket loads while this one adds
  fe nxt = fe_ld(bk + ((size_t)(a.s - 1) * 4 + c) * NL);
#pragma unroll 1
  for (int t = a.s - 1; t >= 0; --t) {
    const fe e = nxt;
    nxt = fe_ld(bk + ((size_t)(t > 0 ? t - 1 : 0) * 4 + c) * NL);
    run = q_add(run, e, c);
    tot = q_add(tot, q_to_niels(run, d2, c), c);
  }
  const fe cn = q_to_niels(run, d2, c);
  const fe tn = q_to_niels(tot, d2, c);
  if (live) {
    fe_st(a.runs + (((size_t)q * 2 + 0) * 4 + c) * NL, cn);
    fe_st(a.runs + (((size_t)q * 2 + 1) * 4 + c) * NL, tn);
  }
}

// n consecutive segments of L buckets (each (C_i, T_i) in Niels form,
// T_i weighted 1..L from the segment's first bucket) as one of nL:
// C = sum C_i, T = sum T_i + [L] sum i C_i. Warp 0 walks the running
// sums of the C_i from the top (run, then acc += run), warp 1 sums the
// T_i; each segment's point loads while the one before it adds. Every
// lane returns warp 0's T (extended); with `with_c` it also stores C's
// and T's Niels forms at out.
__device__ __forceinline__ fd combine(const uint32_t* in, int n, int log2l,
                                      uint32_t* half, const fd& d2,
                                      uint32_t* out, bool with_c) {
  const int c = w_c();
  const int warp = threadIdx.x >> 5;
  const int part = warp ? 4 : 0;
  fd nxt = d_ld(in + ((size_t)(n - 1) * 8 + part + c) * NL);
  fd run = d_identity(c);
  fd acc = d_identity(c);
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    const fd e = nxt;
    nxt = d_ld(in + ((size_t)(i > 0 ? i - 1 : 0) * 8 + part + c) * NL);
    if (warp == 1) {
      acc = w_add(acc, e, c);
    } else if (i >= 1 || with_c) {
      run = w_add(run, e, c);
      if (i >= 1) acc = w_add(acc, w_to_niels(run, d2, c), c);
    }
  }
  if (warp == 1) d_st(half + c * NL, acc);
  __syncthreads();
  if (warp == 0) {
#pragma unroll 1
    for (int i = 0; i < log2l; ++i) acc = w_double(acc, c);
    acc = w_add(acc, w_to_niels(d_ld(half + c * NL), d2, c), c);
    if (with_c) {
      d_st(out + c * NL, w_to_niels(run, d2, c));
      d_st(out + (4 + c) * NL, w_to_niels(acc, d2, c));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(COMBINE_THREADS) x5_groups(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t half[4 * NL];  // warp 1's T sum
  stage_consts26(sm, a.consts);
  const int gi = blockIdx.x;  // the group: j * g + its index in window j
  const Side& s = a.side[gi < a.side[1].g0 ? 0 : 1];
  const int q = gi - s.g0;
  const int r = (q / s.g) * s.k + (q % s.g) * a.f;  // its first run
  combine(a.runs + ((size_t)s.r0 + r) * 2 * 4 * NL, a.f, a.log2s, half,
          d_ld(sm + C_D2), a.groups + (size_t)gi * 2 * 4 * NL, true);
}

__global__ void __launch_bounds__(COMBINE_THREADS) x5_join(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t half[4 * NL];  // warp 1's share
  stage_consts26(sm, a.consts);
  const int c = w_c();
  const int warp = threadIdx.x >> 5;
  const int wt = a.side[0].w + a.side[1].w;
  const int win = blockIdx.x;
  const fd d2 = d_ld(sm + C_D2);
  if (win == wt) {  // the last block: [b]B, a half of the windows a warp
    const int mid = WINDOWS8 / 2;
    fd sb = w_fixed_base8(a.tab8, a.b_bytes, warp ? mid : 0,
                          warp ? WINDOWS8 : mid, c);
    if (warp == 1) d_st(half + c * NL, sb);
    __syncthreads();
    if (warp == 0) {
      sb = w_add(sb, w_to_niels(d_ld(half + c * NL), d2, c), c);
      d_st(a.sums + ((size_t)(wt + 1) * 4 + c) * NL, sb);
    }
    return;
  }
  // W_j = sum_v v B_v: window j's g groups as one segment from v = 1
  const Side& s = a.side[win < a.side[0].w ? 0 : 1];
  const int j = win - s.s0;
  const fd w = combine(a.groups + ((size_t)s.g0 + (size_t)j * s.g) * 2 * 4 *
                                      NL,
                       s.g, a.log2s + a.log2f, half, d2, nullptr, false);
  if (warp == 0) d_st(a.sums + ((size_t)win * 4 + c) * NL, w);
}

__global__ void __launch_bounds__(FINISH_THREADS) x5_finish(Args a) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t ws[MAX_SUMS * 4 * NL];
  __shared__ uint32_t part[2][4][NL];  // Horner A, Horner R
  __shared__ int bad;
  const int wt = a.side[0].w + a.side[1].w;
  if (threadIdx.x == 0) bad = 0;
  for (int i = threadIdx.x; i < (wt + 2) * 4 * NL; i += blockDim.x)
    ws[i] = a.sums[i];
  stage_consts26(sm, a.consts);
  for (int i = threadIdx.x; i < a.nokb; i += blockDim.x)
    if (a.okb[i] == 0) bad = 1;
  const int c = w_c();
  const int warp = threadIdx.x >> 5;
  const fd d2 = d_ld(sm + C_D2);
  {  // Horner over one side's windows, msb first
    const Side& s = a.side[warp];
    const uint32_t* w = ws + (size_t)s.s0 * 4 * NL;
    fd acc = d_ld(w + ((size_t)(s.w - 1) * 4 + c) * NL);
#pragma unroll 1
    for (int j = s.w - 2; j >= 0; --j) {
#pragma unroll 1
      for (int i = 0; i < s.c; ++i) acc = w_double(acc, c);
      acc = w_add(acc, w_to_niels(d_ld(w + ((size_t)j * 4 + c) * NL), d2, c),
                  c);
    }
    d_st(part[warp][c], acc);
  }
  __syncthreads();
  if (warp == 0) {
    fd t = d_ld(ws + ((size_t)(wt + 1) * 4 + c) * NL);  // [b]B
    t = w_add(t, w_to_niels(d_ld(part[0][c]), d2, c), c);
    t = w_add(t, w_to_niels(d_ld(part[1][c]), d2, c), c);
    d_st(a.sums + ((size_t)wt * 4 + c) * NL, t);
#pragma unroll 1
    for (int i = 0; i < 3; ++i) t = w_double(t, c);  // the cofactor
    const fe x = d_gather(d_shfl(t, 0));
    const fe y = d_gather(d_shfl(t, 1));
    const fe z = d_gather(d_shfl(t, 2));
    const bool ident = fe_is_zero(x) && fe_is_zero(fe_sub(y, z));
    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
  }
}

// Args from the C entry's arrays. p: y, sign, perm, psign, starts, ends
// of A, the same of R, then b_bytes, consts, tab8, pts, okb, buckets,
// runs, groups, sums, out. iv: n, c, w of A, the same of R, then S
// (buckets a run, a power of two dividing both sides' m) and F (runs a
// group, a power of two dividing both sides' m / S). Returns the stages'
// grids (blocks), or false where the sums do not fit x5_finish.
bool setup(Args& a, void* const* p, const int* iv, int grid[6]) {
  int pt = 0, bk = 0, rn = 0, gr = 0, sm = 0;
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
    s.g = s.k / iv[7];
    s.pt0 = pt;
    s.b0 = bk;
    s.r0 = rn;
    s.g0 = gr;
    s.s0 = sm;
    pt += s.n;
    bk += s.w * s.m;
    rn += s.w * s.k;
    gr += s.w * s.g;
    sm += s.w;
  }
  a.b_bytes = (const int32_t*)p[12];
  a.consts = (const int32_t*)p[13];
  a.tab8 = (const int32_t*)p[14];
  a.pts = (uint32_t*)p[15];
  a.okb = (uint8_t*)p[16];
  a.buckets = (uint32_t*)p[17];
  a.runs = (uint32_t*)p[18];
  a.groups = (uint32_t*)p[19];
  a.sums = (uint32_t*)p[20];
  a.out = (uint8_t*)p[21];
  a.s = iv[6];
  a.log2s = 0;
  while ((1 << a.log2s) < a.s) ++a.log2s;
  a.f = iv[7];
  a.log2f = 0;
  while ((1 << a.log2f) < a.f) ++a.log2f;
  grid[0] = (pt + BLOCK - 1) / BLOCK;
  grid[1] = (4 * bk + BLOCK - 1) / BLOCK;
  grid[2] = (4 * rn + BLOCK - 1) / BLOCK;
  grid[3] = gr;      // a group a block
  grid[4] = sm + 1;  // a window a block, and [b]B
  grid[5] = 1;
  a.nokb = grid[0];
  return sm + 2 <= MAX_SUMS;
}

int launch(const Args& a, const int grid[6], int stage,
           cudaStream_t stream) {
  switch (stage) {
    case 0:
      x5_decompress<<<grid[0], BLOCK, 0, stream>>>(a);
      break;
    case 1:
      x5_buckets<<<grid[1], BLOCK, 0, stream>>>(a);
      break;
    case 2:
      x5_runs<<<grid[2], BLOCK, 0, stream>>>(a);
      break;
    case 3:
      x5_groups<<<grid[3], COMBINE_THREADS, 0, stream>>>(a);
      break;
    case 4:
      x5_join<<<grid[4], COMBINE_THREADS, 0, stream>>>(a);
      break;
    default:
      x5_finish<<<grid[5], FINISH_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry (ctypes): launches stage `stage` of X5 (0-5: decompress,
// buckets, runs, groups, join, finish) on `stream` and returns its
// cudaError_t (the arrays as setup reads them; 1, cudaErrorInvalidValue,
// where the windows do not fit); the six in order are one X5 run.
extern "C" int x5_rlc_stage(void* const* p, const int* iv, int stage,
                            cudaStream_t stream) {
  Args a;
  int grid[6];
  if (!setup(a, p, iv, grid)) return 1;
  return launch(a, grid, stage, stream);
}
