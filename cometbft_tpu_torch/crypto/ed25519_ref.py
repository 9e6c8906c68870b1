"""Pure-Python ed25519 reference implementation (host side).

This is the correctness oracle for the batched CUDA verifier in
``cometbft_tpu_torch.ops`` and the signing path for host key types. Verification
uses **ZIP-215** point-acceptance semantics, matching the reference engine's
consensus-critical rules (reference: crypto/ed25519/ed25519.go:26-29):

  * non-canonical point encodings (y >= p) are accepted,
  * the encoding with x = 0 and sign bit 1 ("negative zero") is accepted,
  * S must be canonical (S < L),
  * the verification equation is cofactored: [8]([S]B - [k]A - R) == O.

Signing follows RFC 8032 exactly (deterministic nonce).

All arithmetic is Python big-int; speed is adequate for signing, test
oracles, and the single-signature path. The hot batch path lives on the
GPU (ops/verify.py).
"""

from __future__ import annotations

import hashlib

# --- Field / curve constants -------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P            # curve constant d
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)                    # sqrt(-1) mod p

# Base point B: y = 4/5, x recovered with even parity.
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """Recover x from y and the sign bit. Returns None if not on curve.

    ZIP-215: 'negative zero' (x == 0, sign == 1) is *accepted* and yields 0.
    (RFC 8032 would reject it; the reference engine consensus rules are
    ZIP-215 — crypto/ed25519/ed25519.go:26-29.)
    """
    y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate root of u/v: x = u * v^3 * (u * v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x & 1 != sign:
        x = (P - x) % P
    return x


_BX = _recover_x(_BY, 0)
assert _BX is not None

# --- Point arithmetic (extended twisted Edwards coordinates) -----------------
# Point = (X, Y, Z, T) with x = X/Z, y = Y/Z, T = X*Y/Z.
# The addition law is complete on the whole curve group because a = -1 is a
# square mod p and d is a non-square (Bernstein–Lange completeness theorem),
# which matters under ZIP-215: small-order/mixed-order points are admitted.

IDENTITY = (0, 1, 1, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def point_add(p1, p2):
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * D2 % P * T2 % P
    Dd = 2 * Z1 * Z2 % P
    E = B - A
    F = Dd - C
    G = Dd + C
    H = B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p1):
    X1, Y1, Z1, _ = p1
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = A - B
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_neg(p1):
    X1, Y1, Z1, T1 = p1
    return ((P - X1) % P, Y1, Z1, (P - T1) % P)


def scalar_mult(k: int, point) -> tuple:
    acc = IDENTITY
    while k > 0:
        if k & 1:
            acc = point_add(acc, point)
        point = point_double(point)
        k >>= 1
    return acc


def point_equal(p1, p2) -> bool:
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def is_identity(p1) -> bool:
    X1, Y1, Z1, _ = p1
    return X1 % P == 0 and (Y1 - Z1) % P == 0


def compress(point) -> bytes:
    X, Y, Z, _ = point
    zinv = pow(Z, P - 2, P)
    x = X * zinv % P
    y = Y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(s: bytes):
    """ZIP-215 decompression. Returns extended point or None."""
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)  # NOT reduced-checked: y >= p accepted (ZIP-215)
    x = _recover_x(y, sign)
    if x is None:
        return None
    y %= P
    return (x, y, 1, x * y % P)


# --- Signing / verification (RFC 8032 + ZIP-215) -----------------------------


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _clamp(a: bytes) -> int:
    s = bytearray(a)
    s[0] &= 248
    s[31] &= 127
    s[31] |= 64
    return int.from_bytes(bytes(s), "little")


def pubkey_from_seed(seed: bytes) -> bytes:
    return expand_seed(seed)[2]


_EXPANDED_CACHE: dict[bytes, tuple[int, bytes, bytes]] = {}


def expand_seed(seed: bytes) -> tuple[int, bytes, bytes]:
    """seed -> (clamped scalar a, prefix, compressed pubkey A), cached.

    Mirrors the reference engine's expanded-pubkey cache
    (crypto/ed25519/ed25519.go:31,56): the [a]B scalar mult is per-key
    constant and must not be repaid on every vote signature.
    """
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    cached = _EXPANDED_CACHE.get(seed)
    if cached is None:
        h = _sha512(seed)
        a = _clamp(h[:32])
        cached = (a, h[32:], compress(scalar_mult(a, BASE)))
        if len(_EXPANDED_CACHE) >= 4096:  # bound like the reference LRU
            _EXPANDED_CACHE.pop(next(iter(_EXPANDED_CACHE)))
        _EXPANDED_CACHE[seed] = cached
    return cached


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 deterministic signature; returns 64 bytes R||S.

    NOTE: this pure-Python path is variable-time (secret-dependent branches
    and big-int timing). It is the correctness oracle and test signer; the
    production privval signing path delegates to a constant-time backend.
    """
    return sign_expanded(*expand_seed(seed), msg)


def sign_expanded(a: int, prefix: bytes, A: bytes, msg: bytes) -> bytes:
    """:func:`sign` with the key already expanded: (a, prefix, A) as
    :func:`expand_seed` returns them."""
    r = int.from_bytes(_sha512(prefix, msg), "little") % L
    R = compress(scalar_mult(r, BASE))
    k = int.from_bytes(_sha512(R, A, msg), "little") % L
    s = (r + k * a) % L
    return R + int.to_bytes(s, 32, "little")


def challenge_scalar(sig_r: bytes, pubkey: bytes, msg: bytes) -> int:
    """k = SHA512(R || A || M) mod L — shared by host and device paths."""
    return int.from_bytes(_sha512(sig_r, pubkey, msg), "little") % L


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single-signature verification (cofactored equation)."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    s_int = int.from_bytes(sig[32:], "little")
    if s_int >= L:  # S must be canonical under ZIP-215
        return False
    A = decompress(pubkey)
    if A is None:
        return False
    R = decompress(sig[:32])
    if R is None:
        return False
    k = challenge_scalar(sig[:32], pubkey, msg)
    # [8]([S]B - [k]A - R) == O
    sB = scalar_mult(s_int, BASE)
    kA = scalar_mult(k, A)
    acc = point_add(point_add(sB, point_neg(kA)), point_neg(R))
    for _ in range(3):
        acc = point_double(acc)
    return is_identity(acc)
