// Native edwards25519 multiscalar multiplication: the host tier of the
// framework's ed25519 batch verification (reference analog: the
// curve25519-voi batch verify behind crypto/ed25519/ed25519.go:196-228 —
// random-linear-combination over the cofactored equation, one MSM).
//
// Role in the framework (the PyTorch/CUDA package's own copy, built by
// libs/native_build.py):
//   * the host tier for batches below the device crossover —
//     sub-threshold commits (150-validator Cosmos-Hub-sized) and the
//     verify coalescer's small windows verify here at multiscalar speed
//     instead of one signature at a time, and
//   * the challenge packer of ops/verify.pack_bytes (SHA-512 challenges
//     and -k mod L for the device wire).
//
// Split of labor (crypto/host_batch.py drives this via ctypes): Python
// computes the SHA-512 challenges, draws the random 128-bit RLC
// coefficients z_i, enforces S_i < L, and reduces the per-point
// coefficients mod L with CPython bigints (microseconds per batch).
// This file does only what needs native speed: ZIP-215 point
// decompression and the Pippenger bucket MSM over 2N+1 points, checking
//   [8]( [b]B - sum_i [z_i k_i]A_i - sum_i [z_i]R_i ) == O.
//
// Field arithmetic: 5x51-bit limbs on unsigned __int128 accumulators
// (the standard radix-51 schedule for 64-bit targets). Point formulas:
// the same complete a=-1 extended-Edwards formulas as ops/curve.py (see
// its docstring for the ZIP-215 completeness argument). Every add/sub
// output is carried, so limbs stay below 2^52 and every product column
// fits u128 with a wide margin.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

// ------------------------------------------------------------- field

struct fe {
    u64 v[5];
};

const u64 MASK51 = ((u64)1 << 51) - 1;
// 2p per limb: subtraction bias (operands are always carried, < 2^52)
const u64 TWO_P0 = 0xFFFFFFFFFFFDAULL;   // 2*(2^51 - 19)
const u64 TWO_P1234 = 0xFFFFFFFFFFFFEULL;  // 2*(2^51 - 1)

inline fe fe_zero() { return fe{{0, 0, 0, 0, 0}}; }
inline fe fe_one() { return fe{{1, 0, 0, 0, 0}}; }

inline void fe_carry_inline(fe& r) {
    u64 c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
    c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
    c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
    c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += 19 * c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
}

inline fe fe_add(const fe& a, const fe& b) {
    fe r;
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    fe_carry_inline(r);
    return r;
}

inline fe fe_sub(const fe& a, const fe& b) {
    fe r;
    r.v[0] = a.v[0] + TWO_P0 - b.v[0];
    r.v[1] = a.v[1] + TWO_P1234 - b.v[1];
    r.v[2] = a.v[2] + TWO_P1234 - b.v[2];
    r.v[3] = a.v[3] + TWO_P1234 - b.v[3];
    r.v[4] = a.v[4] + TWO_P1234 - b.v[4];
    fe_carry_inline(r);
    return r;
}

inline fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

inline void fe_carry_wide(fe& r, u128 t0, u128 t1, u128 t2, u128 t3,
                          u128 t4) {
    u64 c;
    c = (u64)(t0 >> 51); t0 &= MASK51; t1 += c;
    c = (u64)(t1 >> 51); t1 &= MASK51; t2 += c;
    c = (u64)(t2 >> 51); t2 &= MASK51; t3 += c;
    c = (u64)(t3 >> 51); t3 &= MASK51; t4 += c;
    c = (u64)(t4 >> 51); t4 &= MASK51; t0 += (u128)c * 19;
    c = (u64)(t0 >> 51); t0 &= MASK51; t1 += c;
    r.v[0] = (u64)t0; r.v[1] = (u64)t1; r.v[2] = (u64)t2;
    r.v[3] = (u64)t3; r.v[4] = (u64)t4;
}

fe fe_mul(const fe& a, const fe& b) {
    const u64 *x = a.v, *y = b.v;
    u64 y1_19 = 19 * y[1], y2_19 = 19 * y[2], y3_19 = 19 * y[3],
        y4_19 = 19 * y[4];
    u128 t0 = (u128)x[0] * y[0] + (u128)x[1] * y4_19 + (u128)x[2] * y3_19 +
              (u128)x[3] * y2_19 + (u128)x[4] * y1_19;
    u128 t1 = (u128)x[0] * y[1] + (u128)x[1] * y[0] + (u128)x[2] * y4_19 +
              (u128)x[3] * y3_19 + (u128)x[4] * y2_19;
    u128 t2 = (u128)x[0] * y[2] + (u128)x[1] * y[1] + (u128)x[2] * y[0] +
              (u128)x[3] * y4_19 + (u128)x[4] * y3_19;
    u128 t3 = (u128)x[0] * y[3] + (u128)x[1] * y[2] + (u128)x[2] * y[1] +
              (u128)x[3] * y[0] + (u128)x[4] * y4_19;
    u128 t4 = (u128)x[0] * y[4] + (u128)x[1] * y[3] + (u128)x[2] * y[2] +
              (u128)x[3] * y[1] + (u128)x[4] * y[0];
    fe r;
    fe_carry_wide(r, t0, t1, t2, t3, t4);
    return r;
}

inline fe fe_sq(const fe& a) { return fe_mul(a, a); }

// Fully reduce to the canonical representative in [0, p).
void fe_canon(fe& a) {
    fe_carry_inline(a);
    fe_carry_inline(a);
    // conditional subtract p: q = 1 iff a >= p
    u64 q = (a.v[0] + 19) >> 51;
    q = (a.v[1] + q) >> 51;
    q = (a.v[2] + q) >> 51;
    q = (a.v[3] + q) >> 51;
    q = (a.v[4] + q) >> 51;
    a.v[0] += 19 * q;
    u64 c = 0;
    for (int i = 0; i < 5; i++) {
        u64 t = a.v[i] + c;
        a.v[i] = t & MASK51;
        c = t >> 51;
    }
    // c is the dropped 2^255 bit when a >= p was folded
}

bool fe_is_zero(fe a) {
    fe_canon(a);
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3] | a.v[4]) == 0;
}

bool fe_eq(const fe& a, const fe& b) { return fe_is_zero(fe_sub(a, b)); }

fe fe_frombytes(const uint8_t s[32]) {
    u64 w0, w1, w2, w3;
    memcpy(&w0, s, 8);
    memcpy(&w1, s + 8, 8);
    memcpy(&w2, s + 16, 8);
    memcpy(&w3, s + 24, 8);
    fe r;
    r.v[0] = w0 & MASK51;
    r.v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
    r.v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
    r.v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
    r.v[4] = (w3 >> 12) & MASK51;  // bits 204..254 (sign bit cleared)
    return r;
}

void fe_tobytes(fe a, uint8_t out[32]) {
    fe_canon(a);
    u64 w0 = a.v[0] | (a.v[1] << 51);
    u64 w1 = (a.v[1] >> 13) | (a.v[2] << 38);
    u64 w2 = (a.v[2] >> 26) | (a.v[3] << 25);
    u64 w3 = (a.v[3] >> 39) | (a.v[4] << 12);
    memcpy(out, &w0, 8);
    memcpy(out + 8, &w1, 8);
    memcpy(out + 16, &w2, 8);
    memcpy(out + 24, &w3, 8);
}

fe fe_pow_2_252_m3(const fe& z) {
    // the classic curve25519 addition chain (ops/field.pow_2_252_m3)
    fe z2 = fe_sq(z);
    fe z8 = fe_sq(fe_sq(z2));
    fe z9 = fe_mul(z, z8);
    fe z11 = fe_mul(z2, z9);
    fe z22 = fe_sq(z11);
    fe z_5_0 = fe_mul(z9, z22);
    fe t = z_5_0;
    for (int i = 0; i < 5; i++) t = fe_sq(t);
    fe z_10_0 = fe_mul(t, z_5_0);
    t = z_10_0;
    for (int i = 0; i < 10; i++) t = fe_sq(t);
    fe z_20_0 = fe_mul(t, z_10_0);
    t = z_20_0;
    for (int i = 0; i < 20; i++) t = fe_sq(t);
    fe z_40_0 = fe_mul(t, z_20_0);
    t = z_40_0;
    for (int i = 0; i < 10; i++) t = fe_sq(t);
    fe z_50_0 = fe_mul(t, z_10_0);
    t = z_50_0;
    for (int i = 0; i < 50; i++) t = fe_sq(t);
    fe z_100_0 = fe_mul(t, z_50_0);
    t = z_100_0;
    for (int i = 0; i < 100; i++) t = fe_sq(t);
    fe z_200_0 = fe_mul(t, z_100_0);
    t = z_200_0;
    for (int i = 0; i < 50; i++) t = fe_sq(t);
    fe z_250_0 = fe_mul(t, z_50_0);
    t = fe_sq(fe_sq(z_250_0));
    return fe_mul(t, z);
}

// d and sqrt(-1), canonical little-endian byte encodings.
const uint8_t D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75, 0xab, 0xd8, 0x41,
    0x41, 0x4d, 0x0a, 0x70, 0x00, 0x98, 0xe8, 0x79, 0x77, 0x79, 0x40,
    0xc7, 0x8c, 0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52};
const uint8_t SQRTM1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f,
    0xad, 0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00,
    0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};

fe FE_D, FE_D2, FE_SQRTM1;

// --------------------------------------------------------------- point

struct pt {
    fe x, y, z, t;  // extended coordinates, a = -1
};

pt pt_identity() { return pt{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

pt pt_add(const pt& p, const pt& q) {
    fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
    fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    fe c = fe_mul(fe_mul(p.t, FE_D2), q.t);
    fe zz = fe_mul(p.z, q.z);
    fe d = fe_add(zz, zz);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d, c);
    fe g = fe_add(d, c);
    fe h = fe_add(b, a);
    return pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// Input point in affine-Niels form (y+x, y-x, 2d*x*y; Z == 1): the MSM
// scatter phase adds DECOMPRESSED (affine) input points into buckets
// ~64x per point, so precomputing the Niels triple once per point turns
// each bucket add from 9 into 7 field muls (~20% of total MSM muls).
struct niels {
    fe yplusx, yminusx, t2d;
};

niels to_niels(const pt& p) {  // requires z == 1
    return niels{fe_add(p.y, p.x), fe_sub(p.y, p.x), fe_mul(p.t, FE_D2)};
}

pt pt_add_niels(const pt& p, const niels& q) {
    fe a = fe_mul(fe_sub(p.y, p.x), q.yminusx);
    fe b = fe_mul(fe_add(p.y, p.x), q.yplusx);
    fe c = fe_mul(p.t, q.t2d);
    fe d = fe_add(p.z, p.z);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d, c);
    fe g = fe_add(d, c);
    fe h = fe_add(b, a);
    return pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

pt pt_double(const pt& p) {
    fe a = fe_sq(p.x);
    fe b = fe_sq(p.y);
    fe zz = fe_sq(p.z);
    fe c = fe_add(zz, zz);
    fe h = fe_add(a, b);
    fe e = fe_sub(h, fe_sq(fe_add(p.x, p.y)));
    fe g = fe_sub(a, b);
    fe f = fe_add(c, g);
    return pt{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

bool pt_is_identity(const pt& p) {
    return fe_is_zero(p.x) && fe_eq(p.y, p.z);
}

// ZIP-215 decompression: y >= p folds mod p in limb arithmetic (exactly
// the ZIP-215 acceptance), "negative zero" x accepted.
bool pt_decompress(const uint8_t enc[32], pt& out) {
    int sign = enc[31] >> 7;
    uint8_t yb[32];
    memcpy(yb, enc, 32);
    yb[31] &= 0x7F;
    fe y = fe_frombytes(yb);
    fe yy = fe_sq(y);
    fe u = fe_sub(yy, fe_one());
    fe v = fe_add(fe_mul(FE_D, yy), fe_one());
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    fe x = fe_mul(fe_mul(u, v3), fe_pow_2_252_m3(fe_mul(u, v7)));
    fe vxx = fe_mul(v, fe_sq(x));
    if (!fe_eq(vxx, u)) {
        if (!fe_eq(vxx, fe_neg(u))) return false;
        x = fe_mul(x, FE_SQRTM1);
    }
    fe xc = x;
    fe_canon(xc);
    if ((int)(xc.v[0] & 1) != sign)
        x = fe_neg(xc);
    else
        x = xc;
    out.x = x;
    out.y = y;
    out.z = fe_one();
    out.t = fe_mul(x, y);
    return true;
}

// --------------------------------------------------------------- MSM
// Pippenger, 8-bit unsigned windows: scalars are 32-byte little-endian
// values < L supplied pre-reduced by the caller; window w is byte w.

pt msm(const std::vector<pt>& points, const uint8_t* coeffs, size_t m) {
    const int NWIN = 32, NBUCKET = 255;
    pt acc = pt_identity();
    std::vector<pt> buckets(NBUCKET);
    std::vector<uint8_t> used(NBUCKET);
    // inputs are affine (z == 1, straight from decompression): hoist
    // their Niels form out of the 32-window scatter loop
    std::vector<niels> npts(m);
    for (size_t i = 0; i < m; i++) npts[i] = to_niels(points[i]);
    for (int w = NWIN - 1; w >= 0; w--) {
        if (w != NWIN - 1)
            for (int i = 0; i < 8; i++) acc = pt_double(acc);
        memset(used.data(), 0, NBUCKET);
        for (size_t i = 0; i < m; i++) {
            int d = coeffs[32 * i + w];
            if (!d) continue;
            if (used[d - 1])
                buckets[d - 1] = pt_add_niels(buckets[d - 1], npts[i]);
            else {
                buckets[d - 1] = points[i];
                used[d - 1] = 1;
            }
        }
        pt running = pt_identity(), sum = pt_identity();
        bool have_running = false;
        for (int b = NBUCKET - 1; b >= 0; b--) {
            if (used[b]) {
                running = have_running ? pt_add(running, buckets[b])
                                       : buckets[b];
                have_running = true;
            }
            if (have_running) sum = pt_add(sum, running);
        }
        acc = pt_add(acc, sum);
    }
    return acc;
}

// ------------------------------------------------------ base-point mult
// Fixed-base scalar multiplication for the SIGNING path (sr25519 nonce
// and public points ride this; verification stays on the MSM above).
// 4-bit fixed windows MSB-first with a CONSTANT-TIME table select:
// signing scalars are secrets, so the lookup touches all 16 entries
// with arithmetic masks — no secret-indexed loads, no secret branches
// (fe ops themselves are u64/u128 arithmetic, constant-time on this
// target).

fe fe_invert(const fe& z) {
    // z^(p-2), p-2 = 8*(2^252 - 3) + 3
    fe a = fe_pow_2_252_m3(z);
    a = fe_sq(fe_sq(fe_sq(a)));
    return fe_mul(a, fe_mul(fe_sq(z), z));
}

// canonical encoding of the ed25519 base point (y = 4/5, even x)
const uint8_t B_BYTES[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

niels G_TABLE[16];  // [v]B in Niels form, v = 0..15 ([0]B = identity)

inline void fe_cmov(fe& r, const fe& a, u64 mask) {
    for (int i = 0; i < 5; i++) r.v[i] ^= mask & (r.v[i] ^ a.v[i]);
}

niels ct_select16(const niels table[16], unsigned v) {
    niels r = table[0];
    for (unsigned i = 1; i < 16; i++) {
        // mask = all-ones iff i == v: diff-1 underflows to 2^64-1 only
        // when diff == 0, so its top bit is the equality predicate
        u64 diff = (u64)(i ^ v);
        u64 mask = (u64)(((int64_t)(diff - 1)) >> 63);
        fe_cmov(r.yplusx, table[i].yplusx, mask);
        fe_cmov(r.yminusx, table[i].yminusx, mask);
        fe_cmov(r.t2d, table[i].t2d, mask);
    }
    return r;
}

pt scalar_base_mult(const uint8_t scalar[32]) {
    pt acc = pt_identity();
    for (int w = 63; w >= 0; w--) {
        if (w != 63)
            for (int i = 0; i < 4; i++) acc = pt_double(acc);
        unsigned byte = scalar[w / 2];
        unsigned v = (w & 1) ? (byte >> 4) : (byte & 0x0F);
        acc = pt_add_niels(acc, ct_select16(G_TABLE, v));
    }
    return acc;
}

// ------------------------------------------------- host packing engine
// The per-lane host work of ops/verify.pack_bytes — the SHA-512
// challenge k = H(R||A||M), its reduction mod L, kneg = (L - k) mod L,
// and the S < L canonicality check — moved to C: the Python loop was
// ~9 us/lane (~36 ms of a 4096-lane pack), a material share of the
// device round trip's host side.
//
// SHA-512 round/init constants are NOT hardcoded: Python computes them
// from the FIPS definition (frac bits of cube/square roots of primes,
// exact integer arithmetic) and installs them once via
// edb_sha512_set_constants; parity with hashlib is pinned by tests.

u64 SHA_K[80];
u64 SHA_H0[8];
std::atomic<bool> g_sha_ready{false};

inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512Ctx {
    u64 h[8];
    uint8_t block[128];
    size_t fill;
    u64 total;
};

void sha_init_ctx(Sha512Ctx& c) {
    memcpy(c.h, SHA_H0, sizeof c.h);
    c.fill = 0;
    c.total = 0;
}

void sha_compress(u64 h[8], const uint8_t* p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        u64 v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | p[8 * i + j];
        w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^
                 (w[i - 15] >> 7);
        u64 s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^
                 (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = h[0], b = h[1], c = h[2], d = h[3];
    u64 e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
        u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        u64 ch = (e & f) ^ ((~e) & g);
        u64 t1 = hh + S1 + ch + SHA_K[i] + w[i];
        u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        u64 maj = (a & b) ^ (a & c) ^ (b & c);
        u64 t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

void sha_update(Sha512Ctx& c, const uint8_t* data, size_t len) {
    c.total += len;
    while (len) {
        size_t take = 128 - c.fill;
        if (take > len) take = len;
        memcpy(c.block + c.fill, data, take);
        c.fill += take;
        data += take;
        len -= take;
        if (c.fill == 128) {
            sha_compress(c.h, c.block);
            c.fill = 0;
        }
    }
}

void sha_final(Sha512Ctx& c, uint8_t out[64]) {
    u64 bits = c.total * 8;
    uint8_t pad = 0x80;
    sha_update(c, &pad, 1);
    uint8_t zero = 0;
    while (c.fill != 112) sha_update(c, &zero, 1);
    uint8_t lenb[16] = {0};
    for (int i = 0; i < 8; i++) lenb[15 - i] = (uint8_t)(bits >> (8 * i));
    sha_update(c, lenb, 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(c.h[i] >> (56 - 8 * j));
}

// 4-limb (u64 LE) scalar arithmetic mod L = 2^252 + c.
const u64 L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                        0ULL, 0x1000000000000000ULL};
// c = L - 2^252, two limbs
const u64 C_LIMBS[2] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL};
u64 POW64_MOD_L[4][4];  // 2^(64k) mod L for k = 4..7

bool sc_geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return true;
}

void sc_sub_inplace(u64 a[4], const u64 b[4]) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a[i] - b[i] - borrow;
        a[i] = (u64)t;
        borrow = (u64)(t >> 64) ? 1 : 0;  // wraps to all-ones on underflow
    }
}

void sc_init_pow64() {
    u64 x[4] = {1, 0, 0, 0};
    int idx = 0;
    for (int bit = 1; bit <= 448; bit++) {
        u64 carry = 0;
        for (int i = 0; i < 4; i++) {
            u64 nv = (x[i] << 1) | carry;
            carry = x[i] >> 63;
            x[i] = nv;
        }
        if (sc_geq(x, L_LIMBS)) sc_sub_inplace(x, L_LIMBS);
        if (bit % 64 == 0 && bit >= 256)
            memcpy(POW64_MOD_L[idx++], x, 32);
    }
}

// x (64 bytes LE) mod L -> out 4 limbs canonical
void sc_reduce512(const uint8_t in[64], u64 out[4]) {
    u64 x[8];
    memcpy(x, in, 64);
    // fold limbs 7..4: acc = x[0..3] + sum x[k] * (2^(64k) mod L)
    u128 a0 = x[0], a1 = x[1], a2 = x[2], a3 = x[3], a4 = 0;
    for (int k = 4; k < 8; k++) {
        const u64* m = POW64_MOD_L[k - 4];
        u128 p0 = (u128)x[k] * m[0];
        u128 p1 = (u128)x[k] * m[1];
        u128 p2 = (u128)x[k] * m[2];
        u128 p3 = (u128)x[k] * m[3];
        // add carries and lows SEPARATELY: u64 + u64 wraps before the
        // u128 accumulator would widen it
        a0 += (u64)p0;
        a1 += (p0 >> 64);
        a1 += (u64)p1;
        a2 += (p1 >> 64);
        a2 += (u64)p2;
        a3 += (p2 >> 64);
        a3 += (u64)p3;
        a4 += (p3 >> 64);
    }
    // carry-normalize into 5 limbs (value < 2^320)
    u64 y[5];
    u128 c = a0;
    y[0] = (u64)c; c = (c >> 64) + a1;
    y[1] = (u64)c; c = (c >> 64) + a2;
    y[2] = (u64)c; c = (c >> 64) + a3;
    y[3] = (u64)c; c = (c >> 64) + a4;
    y[4] = (u64)c;
    // x = hi*2^252 + lo, 2^252 = -c (mod L)  =>  x = lo - hi*c (mod L)
    u64 hi[2];  // < 2^68
    hi[0] = (y[3] >> 60) | (y[4] << 4);
    hi[1] = y[4] >> 60;
    u64 lo[4] = {y[0], y[1], y[2], y[3] & 0x0FFFFFFFFFFFFFFFULL};
    // d = hi * c  (< 2^(68+125) = 2^193, 4 limbs)
    u128 q0 = (u128)hi[0] * C_LIMBS[0];
    u128 q1 = (u128)hi[0] * C_LIMBS[1];
    u128 q2 = (u128)hi[1] * C_LIMBS[0];
    u128 q3 = (u128)hi[1] * C_LIMBS[1];
    u64 d[4];
    c = (u64)q0;
    d[0] = (u64)c; c = (c >> 64) + (u64)(q0 >> 64) + (u64)q1 + (u64)q2;
    d[1] = (u64)c;
    c = (c >> 64) + (u64)(q1 >> 64) + (u64)(q2 >> 64) + (u64)q3;
    d[2] = (u64)c; c = (c >> 64) + (u64)(q3 >> 64);
    d[3] = (u64)c;
    // r = lo - d, + L on underflow (d < 2^193 << L so one add suffices)
    u64 r[4];
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u64 di = d[i] + borrow;
        u64 nb = (di < borrow) || (lo[i] < di) ? 1 : 0;
        r[i] = lo[i] - di;
        borrow = nb;
    }
    if (borrow) {
        u128 cc = 0;
        for (int i = 0; i < 4; i++) {
            cc += (u128)r[i] + L_LIMBS[i];
            r[i] = (u64)cc;
            cc >>= 64;
        }
    }
    while (sc_geq(r, L_LIMBS)) sc_sub_inplace(r, L_LIMBS);
    memcpy(out, r, 32);
}

// (z * x) mod L for a 128-bit z and canonical 4-limb x: the product is
// < 2^381, so padding it to 512 bits reuses sc_reduce512.
void sc_mul_z_mod_L(const u64 z[2], const u64 x[4], u64 out[4]) {
    u128 acc[6] = {0, 0, 0, 0, 0, 0};
    for (int zi = 0; zi < 2; zi++)
        for (int xi = 0; xi < 4; xi++) {
            u128 p = (u128)z[zi] * x[xi];
            acc[zi + xi] += (u64)p;
            acc[zi + xi + 1] += (u64)(p >> 64);
        }
    u64 pl[8] = {0};
    u128 carry = 0;
    for (int w = 0; w < 6; w++) {
        carry += acc[w];
        pl[w] = (u64)carry;
        carry >>= 64;
    }
    pl[6] = (u64)carry;
    uint8_t prod[64];
    memcpy(prod, pl, 64);
    sc_reduce512(prod, out);
}

// Decompress-all + cofactored-MSM verdict shared by the two batch
// entries: 1 identity, 0 not, -(2+i) when point i fails to decode.
long msm_verdict(const uint8_t* points_enc, const uint8_t* coeffs,
                 size_t m) {
    std::vector<pt> pts(m);
    for (size_t i = 0; i < m; i++)
        if (!pt_decompress(points_enc + 32 * i, pts[i]))
            return -(long)(2 + i);
    pt res = msm(pts, coeffs, m);
    res = pt_double(pt_double(pt_double(res)));
    return pt_is_identity(res) ? 1 : 0;
}

// ctypes releases the GIL during calls, so first-use init can race
// across threads (consensus verify vs RPC verify): call_once makes the
// table/constant build happen exactly once with a proper barrier.
std::once_flag g_init_once;

void init_tables() {
    FE_D = fe_frombytes(D_BYTES);
    FE_D2 = fe_add(FE_D, FE_D);
    FE_SQRTM1 = fe_frombytes(SQRTM1_BYTES);
    sc_init_pow64();
    pt g;
    pt_decompress(B_BYTES, g);
    pt acc = pt_identity();
    for (int v = 0; v < 16; v++) {
        // to_niels requires z == 1: normalize each multiple
        fe zi = fe_invert(acc.z);
        pt aff;
        aff.x = fe_mul(acc.x, zi);
        aff.y = fe_mul(acc.y, zi);
        aff.z = fe_one();
        aff.t = fe_mul(aff.x, aff.y);
        G_TABLE[v] = to_niels(aff);
        acc = pt_add(acc, g);
    }
}

void ensure_init() { std::call_once(g_init_once, init_tables); }

}  // namespace

extern "C" {

// points_enc: m x 32-byte compressed edwards points (ZIP-215 decoding);
// coeffs: m x 32-byte little-endian scalars, already reduced mod L by
// the caller. Computes [8](sum_i [coeff_i]P_i) and returns 1 if it is
// the identity, 0 if not, -(2 + i) if point i fails to decompress.
long edb_msm_is_identity_x8(const uint8_t* points_enc,
                            const uint8_t* coeffs, size_t m) {
    ensure_init();
    return msm_verdict(points_enc, coeffs, m);
}

// keccak-f[1600] permutation over a 200-byte little-endian-lane state.
// The merlin/STROBE transcript layer (crypto/sr25519.py) permutes ~6x
// per signature and per verification-challenge; the pure-Python
// permutation was ~1 ms — the whole remaining signing cost once the
// scalar mult went native.
void edb_keccak_f1600(uint8_t state[200]) {
    static const u64 RC[24] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
        0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
        0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
    static const int ROTC[5][5] = {{0, 36, 3, 41, 18},
                                   {1, 44, 10, 45, 2},
                                   {62, 6, 43, 15, 61},
                                   {28, 55, 25, 21, 56},
                                   {27, 20, 39, 8, 14}};
    u64 a[25];
    memcpy(a, state, 200);
    for (int round = 0; round < 24; round++) {
        u64 c[5], d[5], b[25];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++) {
            u64 t = c[(x + 1) % 5];
            d[x] = c[(x + 4) % 5] ^ ((t << 1) | (t >> 63));
        }
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                int r = ROTC[x][y];
                u64 v = a[x + 5 * y];
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    r ? ((v << r) | (v >> (64 - r))) : v;
            }
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] =
                    b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                    b[(x + 2) % 5 + 5 * y]);
        a[0] ^= RC[round];
    }
    memcpy(state, a, 200);
}

// [s]B for a 32-byte little-endian scalar (caller reduces mod L), out =
// affine x || y, 64 bytes little-endian. Constant-time window select:
// this is the SIGNING primitive (sr25519 public/nonce points) — the
// scalar is secret.
void edb_scalar_base_mult_xy(const uint8_t scalar[32], uint8_t out[64]) {
    ensure_init();
    pt p = scalar_base_mult(scalar);
    fe zi = fe_invert(p.z);
    fe x = fe_mul(p.x, zi);
    fe y = fe_mul(p.y, zi);
    fe_tobytes(x, out);
    fe_tobytes(y, out + 32);
}

// Install SHA-512 constants (80 round + 8 init words, big-endian u64
// values) computed by the Python side from the FIPS definition.
void edb_sha512_set_constants(const uint64_t* k80, const uint64_t* h8) {
    memcpy(SHA_K, k80, sizeof SHA_K);
    memcpy(SHA_H0, h8, sizeof SHA_H0);
    g_sha_ready = true;
}

// Batched challenge packing: per lane i, recs holds A(32) | R(32) | S(32)
// and msgs[offs[i]:offs[i+1]] the sign bytes. Computes
// k = SHA512(R || A || M) mod L, writes (L - k) mod L little-endian to
// out_kneg, and out_ok[i] = (S < L). Returns 0, or -1 if constants were
// never installed.
long edb_pack_challenges(const uint8_t* recs, const uint8_t* msgs,
                         const uint64_t* offs, size_t n,
                         uint8_t* out_kneg, uint8_t* out_ok) {
    if (!g_sha_ready) return -1;
    ensure_init();
    for (size_t i = 0; i < n; i++) {
        const uint8_t* a = recs + 96 * i;
        const uint8_t* r = a + 32;
        const uint8_t* s = a + 64;
        Sha512Ctx c;
        sha_init_ctx(c);
        sha_update(c, r, 32);
        sha_update(c, a, 32);
        sha_update(c, msgs + offs[i], (size_t)(offs[i + 1] - offs[i]));
        uint8_t digest[64];
        sha_final(c, digest);
        u64 k[4];
        sc_reduce512(digest, k);
        // kneg = (L - k) mod L
        u64 kneg[4] = {0, 0, 0, 0};
        if (k[0] | k[1] | k[2] | k[3]) {
            memcpy(kneg, L_LIMBS, 32);
            sc_sub_inplace(kneg, k);
        }
        memcpy(out_kneg + 32 * i, kneg, 32);
        u64 sv[4];
        memcpy(sv, s, 32);
        out_ok[i] = sc_geq(sv, L_LIMBS) ? 0 : 1;
    }
    return 0;
}

// Fused happy-path batch verification: per lane i, recs holds
// A(32) | R(32) | S(32), msgs[offs[i]:offs[i+1]] the sign bytes, and
// zs 16 random bytes (the RLC coefficient, drawn by the caller from a
// CSPRNG). Computes k_i = SHA512(R||A||M) mod L, the coefficients
// -(z_i*k_i) mod L for A_i and +z_i for -R_i, the basepoint scalar
// b = sum z_i*s_i mod L, and runs the cofactored MSM — the entire
// per-lane preparation that used to be Python bigints. Returns the MSM
// verdict (1 valid, 0 fail, -(2+i) decode failure at MSM point i), or
// -1 if SHA constants were never installed. Rejecting S >= L stays the
// CALLER's job (it filters those lanes out before building recs).
long edb_verify_batch(const uint8_t* recs, const uint8_t* msgs,
                      const uint64_t* offs, const uint8_t* zs, size_t n) {
    if (!g_sha_ready) return -1;
    ensure_init();
    std::vector<uint8_t> points(32 * (2 * n + 1));
    std::vector<uint8_t> coeffs(32 * (2 * n + 1));
    u64 b[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < n; i++) {
        const uint8_t* a = recs + 96 * i;
        const uint8_t* r = a + 32;
        const uint8_t* s = a + 64;
        Sha512Ctx c;
        sha_init_ctx(c);
        sha_update(c, r, 32);
        sha_update(c, a, 32);
        sha_update(c, msgs + offs[i], (size_t)(offs[i + 1] - offs[i]));
        uint8_t digest[64];
        sha_final(c, digest);
        u64 k[4];
        sc_reduce512(digest, k);
        u64 z[2];
        memcpy(z, zs + 16 * i, 16);
        u64 zk[4];
        sc_mul_z_mod_L(z, k, zk);
        // coeff for A_i: (L - zk) mod L
        u64 czk[4] = {0, 0, 0, 0};
        if (zk[0] | zk[1] | zk[2] | zk[3]) {
            memcpy(czk, L_LIMBS, 32);
            sc_sub_inplace(czk, zk);
        }
        memcpy(&points[32 * (2 * i)], a, 32);
        memcpy(&coeffs[32 * (2 * i)], czk, 32);
        // -R_i with coefficient +z (sign-bit flip; short coeff keeps
        // half the Pippenger windows idle — same trick as the caller)
        memcpy(&points[32 * (2 * i + 1)], r, 32);
        points[32 * (2 * i + 1) + 31] ^= 0x80;
        memcpy(&coeffs[32 * (2 * i + 1)], z, 16);
        memset(&coeffs[32 * (2 * i + 1)] + 16, 0, 16);
        // b += (z * s) mod L
        u64 sv[4];
        memcpy(sv, s, 32);
        u64 zsv[4];
        sc_mul_z_mod_L(z, sv, zsv);
        u128 cc = 0;
        for (int w = 0; w < 4; w++) {
            cc += (u128)b[w] + zsv[w];
            b[w] = (u64)cc;
            cc >>= 64;
        }
        // b < 2L after the add (both operands canonical): one subtract
        if (cc || sc_geq(b, L_LIMBS)) sc_sub_inplace(b, L_LIMBS);
    }
    memcpy(&points[32 * 2 * n], B_BYTES, 32);
    memcpy(&coeffs[32 * 2 * n], b, 32);
    return msm_verdict(points.data(), coeffs.data(), 2 * n + 1);
}

// ---------------------------------------------------------------------
// STROBE-128 / merlin — the schnorrkel transcript layer.
//
// Mirrors crypto/sr25519.py's Strobe128/Transcript subset byte-for-byte
// (parity pinned by tests against the Python state machine, which is
// itself pinned to merlin's published protocol vector). Verify-side
// challenges are the sr25519 batch hot path (reference:
// crypto/sr25519/batch.go:14-46): each lane permutes the sponge ~6
// times, and before this the absorb/squeeze byte pushing ran in Python.
// ---------------------------------------------------------------------

namespace {

constexpr int STROBE_R = 166;  // security level 128 -> rate 166

struct Strobe {
    uint8_t st[200];
    uint8_t pos, pos_begin, flags;
};

void strobe_f(Strobe& s) {
    s.st[s.pos] ^= s.pos_begin;
    s.st[s.pos + 1] ^= 0x04;
    s.st[STROBE_R + 1] ^= 0x80;
    edb_keccak_f1600(s.st);
    s.pos = 0;
    s.pos_begin = 0;
}

void strobe_absorb(Strobe& s, const uint8_t* d, size_t n) {
    for (size_t i = 0; i < n; i++) {
        s.st[s.pos++] ^= d[i];
        if (s.pos == STROBE_R) strobe_f(s);
    }
}

void strobe_begin(Strobe& s, uint8_t flags) {
    // header absorbs the OLD pos_begin, then records the new one
    uint8_t hdr[2] = {s.pos_begin, flags};
    s.pos_begin = (uint8_t)(s.pos + 1);
    s.flags = flags;
    strobe_absorb(s, hdr, 2);
    if ((flags & 0x24) && s.pos != 0) strobe_f(s);  // C|K force a round
}

void strobe_meta_ad(Strobe& s, const uint8_t* d, size_t n) {
    strobe_begin(s, 0x12);  // M|A
    strobe_absorb(s, d, n);
}

void strobe_ad(Strobe& s, const uint8_t* d, size_t n) {
    strobe_begin(s, 0x02);  // A
    strobe_absorb(s, d, n);
}

void strobe_prf(Strobe& s, uint8_t* out, size_t n) {
    strobe_begin(s, 0x07);  // I|A|C
    for (size_t i = 0; i < n; i++) {
        out[i] = s.st[s.pos];
        s.st[s.pos++] = 0;
        if (s.pos == STROBE_R) strobe_f(s);
    }
}

// ---- ristretto255 (RFC 9496) decode -> compressed edwards ----
// sr25519 feeds the SAME curve machinery as ed25519 (host MSM and device
// kernel both take compressed edwards points); this is the per-lane
// ristretto_decode + edwards compression that was 4 Python modexps.

bool fe_isneg(const fe& a) {
    uint8_t b[32];
    fe_tobytes(a, b);
    return b[0] & 1;
}

fe fe_abs(const fe& a) { return fe_isneg(a) ? fe_neg(a) : a; }

// sqrt_ratio_m1 specialized to u == 1 (RFC 9496 §4.2): out = 1/sqrt(v)
// (or 1/sqrt(i*v)); returns was_square.
bool fe_invsqrt(const fe& v, fe& out) {
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    fe r = fe_mul(v3, fe_pow_2_252_m3(v7));
    fe check = fe_mul(v, fe_sq(r));
    fe one = fe_one();
    bool correct = fe_eq(check, one);
    bool flipped = fe_eq(check, fe_neg(one));
    bool flipped_i = fe_eq(check, fe_neg(FE_SQRTM1));
    if (flipped || flipped_i) r = fe_mul(r, FE_SQRTM1);
    out = fe_abs(r);
    return correct || flipped;
}

// RFC 9496 §4.3.1 decode; writes the compressed edwards encoding of
// the decoded (affine) point. False for non-canonical/negative/invalid.
bool ristretto_to_edwards(const uint8_t enc[32], uint8_t out[32]) {
    fe s = fe_frombytes(enc);
    uint8_t canon[32];
    fe_tobytes(s, canon);
    if (memcmp(canon, enc, 32) != 0) return false;  // s >= P
    if (enc[0] & 1) return false;                   // s negative
    fe ss = fe_sq(s);
    fe u1 = fe_sub(fe_one(), ss);
    fe u2 = fe_add(fe_one(), ss);
    fe u2s = fe_sq(u2);
    fe v = fe_sub(fe_neg(fe_mul(FE_D, fe_sq(u1))), u2s);
    fe invsqrt;
    bool ws = fe_invsqrt(fe_mul(v, u2s), invsqrt);
    fe den_x = fe_mul(invsqrt, u2);
    fe den_y = fe_mul(fe_mul(invsqrt, den_x), v);
    fe x = fe_abs(fe_mul(fe_add(s, s), den_x));
    fe y = fe_mul(u1, den_y);
    fe t = fe_mul(x, y);
    if (!ws || fe_isneg(t) || fe_is_zero(y)) return false;
    uint8_t xb[32];
    fe_tobytes(x, xb);
    fe_tobytes(y, out);
    out[31] |= (uint8_t)((xb[0] & 1) << 7);
    return true;
}

// merlin append_message: meta_AD(label || LE32(len)); AD(message)
void merlin_append(Strobe& s, const char* label, size_t label_len,
                   const uint8_t* msg, size_t msg_len) {
    uint8_t hdr[20];
    memcpy(hdr, label, label_len);
    hdr[label_len + 0] = (uint8_t)(msg_len);
    hdr[label_len + 1] = (uint8_t)(msg_len >> 8);
    hdr[label_len + 2] = (uint8_t)(msg_len >> 16);
    hdr[label_len + 3] = (uint8_t)(msg_len >> 24);
    strobe_meta_ad(s, hdr, label_len + 4);
    strobe_ad(s, msg, msg_len);
}

}  // namespace

// Batched schnorrkel verification challenges. ``ctx`` is the 203-byte
// serialized STROBE state (200-byte sponge || pos || pos_begin ||
// cur_flags) of a merlin transcript already carrying
// Transcript("SigningContext") + append_message("", signing_context) —
// a pure function of the signing context, built once by the caller and
// cached. Per lane i, recs holds pk(32) | R(32) and
// msgs[offs[i]:offs[i+1]] the sign bytes; writes
// k_i = PRF64("sign:c") mod L (32 bytes little-endian) to out_k.
long edb_sr_challenge_batch(const uint8_t* ctx, const uint8_t* recs,
                            const uint8_t* msgs, const uint64_t* offs,
                            size_t n, uint8_t* out_k) {
    ensure_init();  // sc_reduce512 needs POW64_MOD_L
    Strobe base;
    memcpy(base.st, ctx, 200);
    base.pos = ctx[200];
    base.pos_begin = ctx[201];
    base.flags = ctx[202];
    for (size_t i = 0; i < n; i++) {
        Strobe s = base;
        merlin_append(s, "sign-bytes", 10, msgs + offs[i],
                      (size_t)(offs[i + 1] - offs[i]));
        merlin_append(s, "proto-name", 10,
                      (const uint8_t*)"Schnorr-sig", 11);
        merlin_append(s, "sign:pk", 7, recs + 64 * i, 32);
        merlin_append(s, "sign:R", 6, recs + 64 * i + 32, 32);
        // challenge_bytes("sign:c", 64): meta_AD(label||LE32(64)); PRF
        static const uint8_t clbl[10] = {'s', 'i', 'g', 'n', ':', 'c',
                                         64,  0,   0,   0};
        strobe_meta_ad(s, clbl, 10);
        uint8_t prf[64];
        strobe_prf(s, prf, 64);
        u64 k[4];
        sc_reduce512(prf, k);
        memcpy(out_k + 32 * i, k, 32);
    }
    return 0;
}

// Batched ristretto255 -> compressed-edwards conversion (RFC 9496
// decode + edwards compression): out_enc[i] gets the 32-byte edwards
// encoding, out_ok[i] = 1 iff encs[i] is a valid canonical ristretto
// encoding. Feeds both sr25519 batch paths (host MSM and device kernel
// take compressed edwards points).
void edb_ristretto_to_edwards(const uint8_t* encs, size_t m,
                              uint8_t* out_enc, uint8_t* out_ok) {
    ensure_init();
    for (size_t i = 0; i < m; i++)
        out_ok[i] =
            ristretto_to_edwards(encs + 32 * i, out_enc + 32 * i) ? 1 : 0;
}

// Batched decompress-only check (ZIP-215): out[i] = 1 if points_enc[i]
// decodes. Used for fast per-lane attribution of decode failures.
void edb_decompress_ok(const uint8_t* points_enc, size_t m, uint8_t* out) {
    ensure_init();
    pt tmp;
    for (size_t i = 0; i < m; i++)
        out[i] = pt_decompress(points_enc + 32 * i, tmp) ? 1 : 0;
}

}  // extern "C"
