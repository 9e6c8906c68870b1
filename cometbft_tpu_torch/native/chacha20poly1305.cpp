// RFC 8439 ChaCha20-Poly1305 for the secret connection's sealed frames.
//
// crypto/aead.py builds this file with g++ (libs/native_build) into
// build/native/ and calls it through ctypes when the `cryptography` wheel
// is not installed. It computes the function of aead.py's pure-Python
// construction (ChaCha20Poly1305Fallback), which the tests hold it
// against byte for byte: ChaCha20 with a 32-bit block counter and a
// 96-bit nonce, the one-time Poly1305 key from block 0, the payload
// XORed from block 1, and the tag over aad || pad16 || ct || pad16 ||
// le64(len(aad)) || le64(len(ct)). Poly1305 runs on three 44/44/42-bit
// limbs with 128-bit products (poly1305-donna's 64-bit layout).
//
// C interface (every length in bytes):
//   cp_seal(key, nonce, aad, aad_len, pt, len, out)
//       writes len bytes of ciphertext and the 16-byte tag to out.
//   cp_open(key, nonce, aad, aad_len, ct, len, out)
//       ct is ciphertext || tag (len >= 16); checks the tag in constant
//       time and writes the len - 16 bytes of plaintext to out, or
//       returns -1 and writes nothing when the tag does not match.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

typedef unsigned __int128 u128;

inline uint32_t load32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

inline uint64_t load64(const uint8_t* p) {
    return (uint64_t)load32(p) | ((uint64_t)load32(p + 4) << 32);
}

inline void store32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
}

inline void store64(uint8_t* p, uint64_t v) {
    store32(p, (uint32_t)v);
    store32(p + 4, (uint32_t)(v >> 32));
}

inline uint32_t rotl(uint32_t v, int n) { return (v << n) | (v >> (32 - n)); }

#define QR(a, b, c, d)                  \
    a += b; d ^= a; d = rotl(d, 16);    \
    c += d; b ^= c; b = rotl(b, 12);    \
    a += b; d ^= a; d = rotl(d, 8);     \
    c += d; b ^= c; b = rotl(b, 7);

struct ChaCha {
    uint32_t in[16];

    ChaCha(const uint8_t* key, const uint8_t* nonce) {
        in[0] = 0x61707865; in[1] = 0x3320646e;
        in[2] = 0x79622d32; in[3] = 0x6b206574;
        for (int i = 0; i < 8; i++) in[4 + i] = load32(key + 4 * i);
        in[12] = 0;
        for (int i = 0; i < 3; i++) in[13 + i] = load32(nonce + 4 * i);
    }

    void block(uint32_t counter, uint8_t out[64]) {
        uint32_t x[16];
        in[12] = counter;
        memcpy(x, in, sizeof x);
        for (int i = 0; i < 10; i++) {
            QR(x[0], x[4], x[8], x[12]);
            QR(x[1], x[5], x[9], x[13]);
            QR(x[2], x[6], x[10], x[14]);
            QR(x[3], x[7], x[11], x[15]);
            QR(x[0], x[5], x[10], x[15]);
            QR(x[1], x[6], x[11], x[12]);
            QR(x[2], x[7], x[8], x[13]);
            QR(x[3], x[4], x[9], x[14]);
        }
        for (int i = 0; i < 16; i++) store32(out + 4 * i, x[i] + in[i]);
    }

    // out = data XOR the key stream from block `counter` on
    void xor_stream(uint32_t counter, const uint8_t* data, size_t len,
                    uint8_t* out) {
        uint8_t ks[64];
        for (size_t off = 0; off < len; off += 64, counter++) {
            block(counter, ks);
            size_t n = len - off < 64 ? len - off : 64;
            for (size_t i = 0; i < n; i++) out[off + i] = data[off + i] ^ ks[i];
        }
    }
};

const uint64_t M44 = 0xfffffffffffULL;
const uint64_t M42 = 0x3ffffffffffULL;

struct Poly1305 {
    uint64_t r0, r1, r2, s1, s2, h0 = 0, h1 = 0, h2 = 0, pad0, pad1;

    explicit Poly1305(const uint8_t key[32]) {
        uint64_t t0 = load64(key), t1 = load64(key + 8);
        r0 = t0 & 0xffc0fffffffULL;
        r1 = ((t0 >> 44) | (t1 << 20)) & 0xfffffc0ffffULL;
        r2 = (t1 >> 24) & 0x00ffffffc0fULL;
        s1 = r1 * (5 << 2);
        s2 = r2 * (5 << 2);
        pad0 = load64(key + 16);
        pad1 = load64(key + 24);
    }

    // one full 16-byte block, its 2^128 bit set
    void block(const uint8_t* m) {
        uint64_t t0 = load64(m), t1 = load64(m + 8);
        h0 += t0 & M44;
        h1 += ((t0 >> 44) | (t1 << 20)) & M44;
        h2 += ((t1 >> 24) & M42) | (1ULL << 40);
        u128 d0 = (u128)h0 * r0 + (u128)h1 * s2 + (u128)h2 * s1;
        u128 d1 = (u128)h0 * r1 + (u128)h1 * r0 + (u128)h2 * s2;
        u128 d2 = (u128)h0 * r2 + (u128)h1 * r1 + (u128)h2 * r0;
        uint64_t c = (uint64_t)(d0 >> 44);
        h0 = (uint64_t)d0 & M44;
        d1 += c;
        c = (uint64_t)(d1 >> 44);
        h1 = (uint64_t)d1 & M44;
        d2 += c;
        c = (uint64_t)(d2 >> 42);
        h2 = (uint64_t)d2 & M42;
        h0 += c * 5;
        c = h0 >> 44;
        h0 &= M44;
        h1 += c;
    }

    // bytes zero-padded to a multiple of 16, as the AEAD's MAC data is
    void padded(const uint8_t* m, size_t len) {
        size_t full = len & ~(size_t)15;
        for (size_t off = 0; off < full; off += 16) block(m + off);
        if (len != full) {
            uint8_t last[16] = {0};
            memcpy(last, m + full, len - full);
            block(last);
        }
    }

    void finish(uint8_t tag[16]) {
        uint64_t c = h1 >> 44;
        h1 &= M44;
        h2 += c; c = h2 >> 42; h2 &= M42;
        h0 += c * 5; c = h0 >> 44; h0 &= M44;
        h1 += c; c = h1 >> 44; h1 &= M44;
        h2 += c; c = h2 >> 42; h2 &= M42;
        h0 += c * 5; c = h0 >> 44; h0 &= M44;
        h1 += c;
        // h - p, kept when h >= p
        uint64_t g0 = h0 + 5;
        c = g0 >> 44; g0 &= M44;
        uint64_t g1 = h1 + c;
        c = g1 >> 44; g1 &= M44;
        uint64_t g2 = h2 + c - (1ULL << 42);
        c = (g2 >> 63) - 1;  // all ones when h >= p
        g0 &= c; g1 &= c; g2 &= c;
        c = ~c;
        h0 = (h0 & c) | g0;
        h1 = (h1 & c) | g1;
        h2 = (h2 & c) | g2;
        // + s, mod 2^128
        h0 += pad0 & M44;
        c = h0 >> 44; h0 &= M44;
        h1 += (((pad0 >> 44) | (pad1 << 20)) & M44) + c;
        c = h1 >> 44; h1 &= M44;
        h2 += ((pad1 >> 24) & M42) + c;
        h2 &= M42;
        store64(tag, h0 | (h1 << 44));
        store64(tag + 8, (h1 >> 20) | (h2 << 24));
    }
};

void aead_tag(ChaCha& cc, const uint8_t* aad, size_t aad_len,
              const uint8_t* ct, size_t len, uint8_t tag[16]) {
    uint8_t otk[64];
    cc.block(0, otk);
    Poly1305 mac(otk);
    mac.padded(aad, aad_len);
    mac.padded(ct, len);
    uint8_t lens[16];
    store64(lens, (uint64_t)aad_len);
    store64(lens + 8, (uint64_t)len);
    mac.block(lens);
    mac.finish(tag);
}

}  // namespace

extern "C" int cp_seal(const uint8_t* key, const uint8_t* nonce,
                       const uint8_t* aad, size_t aad_len, const uint8_t* pt,
                       size_t len, uint8_t* out) {
    ChaCha cc(key, nonce);
    cc.xor_stream(1, pt, len, out);
    aead_tag(cc, aad, aad_len, out, len, out + len);
    return 0;
}

extern "C" int cp_open(const uint8_t* key, const uint8_t* nonce,
                       const uint8_t* aad, size_t aad_len, const uint8_t* ct,
                       size_t len, uint8_t* out) {
    if (len < 16) return -1;
    size_t n = len - 16;
    ChaCha cc(key, nonce);
    uint8_t tag[16];
    aead_tag(cc, aad, aad_len, ct, n, tag);
    uint8_t diff = 0;
    for (int i = 0; i < 16; i++) diff |= tag[i] ^ ct[n + i];
    if (diff) return -1;
    cc.xor_stream(1, ct, n, out);
    return 0;
}
