"""secp256k1 ECDSA keys (reference: crypto/secp256k1/secp256k1.go:227).

Host-side only, like the reference: btcec has no batch interface and
secp256k1 is off the consensus hot path. The curve arithmetic is done
here in Python integers (Jacobian coordinates), with no third-party
library, so every machine that runs the package verifies secp256k1
signatures the same way: there is no build in which they all verify
False.

Wire formats match the reference: 33-byte compressed SEC1 public keys,
32-byte big-endian private keys, 64-byte raw r || s signatures over
SHA-256 of the message with the low-S rule (secp256k1.go signs with
RFC 6979 and canonical low s, and rejects s > n/2), and addresses
RIPEMD160(SHA256(pubkey)), the Bitcoin-style address the reference keeps
for this key type (secp256k1.go:30-40). Signing uses RFC 6979's
deterministic nonce; verification accepts any valid nonce.

RIPEMD-160 comes from hashlib where its OpenSSL provides it (OpenSSL 3
builds may leave it out) and otherwise from :func:`ripemd160_plain`, the
module's own implementation, which the tests hold equal to hashlib's.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from .keys import SECP256K1_KEY_TYPE, Address

PUBKEY_SIZE = 33
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 64

# the curve y^2 = x^3 + 7 over F_p, its base point G and order n
_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_B = 7

# ---------------------------------------------------------------------------
# curve arithmetic: Jacobian (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z = 0 is
# the point at infinity
# ---------------------------------------------------------------------------

_INF = (1, 1, 0)


def _jdouble(p):
    x, y, z = p
    if z == 0 or y == 0:
        return _INF
    ysq = y * y % _P
    s = 4 * x * ysq % _P
    m = 3 * x * x % _P  # a = 0
    nx = (m * m - 2 * s) % _P
    ny = (m * (s - nx) - 8 * ysq * ysq) % _P
    nz = 2 * y * z % _P
    return nx, ny, nz


def _jadd(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1sq, z2sq = z1 * z1 % _P, z2 * z2 % _P
    u1, u2 = x1 * z2sq % _P, x2 * z1sq % _P
    s1, s2 = y1 * z2sq * z2 % _P, y2 * z1sq * z1 % _P
    if u1 == u2:
        return _jdouble(p) if s1 == s2 else _INF
    h = (u2 - u1) % _P
    r = (s2 - s1) % _P
    hsq = h * h % _P
    hcu = hsq * h % _P
    nx = (r * r - hcu - 2 * u1 * hsq) % _P
    ny = (r * (u1 * hsq - nx) - s1 * hcu) % _P
    nz = h * z1 * z2 % _P
    return nx, ny, nz


def _jmul(k: int, p):
    acc = _INF
    for bit in bin(k)[2:]:
        acc = _jdouble(acc)
        if bit == "1":
            acc = _jadd(acc, p)
    return acc


def _affine(p):
    """(x, y) of a Jacobian point, or None for the point at infinity."""
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, _P)
    zi2 = zi * zi % _P
    return x * zi2 % _P, y * zi2 * zi % _P


_G = (_GX, _GY, 1)


def decompress(data: bytes):
    """A 33-byte compressed SEC1 point -> (x, y), or None when it is not
    one: a prefix other than 2 or 3, x >= p, or no y on the curve."""
    if len(data) != PUBKEY_SIZE or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= _P:
        return None
    ysq = (pow(x, 3, _P) + _B) % _P
    y = pow(ysq, (_P + 1) // 4, _P)  # p = 3 mod 4
    if y * y % _P != ysq:
        return None
    if y & 1 != data[0] & 1:
        y = _P - y
    return x, y


def compress(pt) -> bytes:
    x, y = pt
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ECDSA over SHA-256 of ``msg`` with the low-S rule: r and s in
    [1, n), s <= n/2, and the key a compressed point of the curve."""
    if len(sig) != SIGNATURE_SIZE:
        return False
    q = decompress(pubkey)
    if q is None:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    # low-S only: the reference rejects the malleable high-S form
    if r == 0 or s == 0 or r >= _N or s > _N // 2:
        return False
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, _N)
    pt = _affine(_jadd(_jmul(e * w % _N, _G), _jmul(r * w % _N, (*q, 1))))
    return pt is not None and pt[0] % _N == r


def _rfc6979_nonces(d: int, h1: bytes):
    """RFC 6979 section 3.2 with HMAC-SHA256: the candidate nonces for
    key ``d`` and message hash ``h1``, in order."""
    x = d.to_bytes(32, "big")
    h = (int.from_bytes(h1, "big") % _N).to_bytes(32, "big")
    v, k = b"\x01" * 32, b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        t = int.from_bytes(v, "big")
        if 0 < t < _N:
            yield t
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: bytes, msg: bytes) -> bytes:
    """64-byte r || s over SHA-256 of ``msg``, s normalized to low S."""
    d = int.from_bytes(priv, "big")
    if not 0 < d < _N:
        raise ValueError("secp256k1 private key out of range")
    h1 = hashlib.sha256(msg).digest()
    e = int.from_bytes(h1, "big")
    for k in _rfc6979_nonces(d, h1):
        pt = _affine(_jmul(k, _G))
        r = pt[0] % _N
        if r == 0:
            continue
        s = pow(k, -1, _N) * (e + r * d) % _N
        if s == 0:
            continue
        if s > _N // 2:
            s = _N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")
    raise AssertionError("unreachable")


def public_key(priv: bytes) -> bytes:
    """The 33-byte compressed public key of a private key."""
    d = int.from_bytes(priv, "big")
    if not 0 < d < _N:
        raise ValueError("secp256k1 private key out of range")
    return compress(_affine(_jmul(d, _G)))


# ---------------------------------------------------------------------------
# RIPEMD-160 (for the address)
# ---------------------------------------------------------------------------

_RL = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
_RR = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
_SL = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
_SR = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
_KL = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_KR = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
_M32 = 0xFFFFFFFF


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return (x | ~y) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _rol32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def ripemd160_plain(data: bytes) -> bytes:
    """RIPEMD-160 in Python (Dobbertin, Bosselaers and Preneel, 1996)."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = bytes(data) + b"\x80"
    msg += b"\x00" * ((56 - len(msg)) % 64)
    msg += (8 * len(data) & (2**64 - 1)).to_bytes(8, "little")
    for off in range(0, len(msg), 64):
        x = [int.from_bytes(msg[off + 4 * i : off + 4 * i + 4], "little")
             for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = _rol32((al + _rmd_f(j, bl, cl, dl) + x[_RL[j]]
                        + _KL[j // 16]) & _M32, _SL[j]) + el & _M32
            al, el, dl, cl, bl = el, dl, _rol32(cl, 10), bl, t
            t = _rol32((ar + _rmd_f(79 - j, br, cr, dr) + x[_RR[j]]
                        + _KR[j // 16]) & _M32, _SR[j]) + er & _M32
            ar, er, dr, cr, br = er, dr, _rol32(cr, 10), br, t
        t = (h[1] + cl + dr) & _M32
        h[1] = (h[2] + dl + er) & _M32
        h[2] = (h[3] + el + ar) & _M32
        h[3] = (h[4] + al + br) & _M32
        h[4] = (h[0] + bl + cr) & _M32
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


def _hashlib_has_ripemd160() -> bool:
    try:
        hashlib.new("ripemd160")
    except (ValueError, TypeError):
        return False
    return True


HASHLIB_RIPEMD160 = _hashlib_has_ripemd160()


def ripemd160(data: bytes) -> bytes:
    if HASHLIB_RIPEMD160:
        return hashlib.new("ripemd160", data).digest()
    return ripemd160_plain(data)


def _address(pubkey33: bytes) -> bytes:
    return ripemd160(hashlib.sha256(pubkey33).digest())


# ---------------------------------------------------------------------------
# key types (crypto.PubKey / PrivKey contracts)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Secp256k1PubKey:
    data: bytes  # 33-byte compressed SEC1 point

    def __post_init__(self) -> None:
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("secp256k1 pubkey must be 33 bytes")

    @property
    def type(self) -> str:
        return SECP256K1_KEY_TYPE

    def address(self) -> bytes:
        return Address(_address(self.data))

    def bytes(self) -> bytes:
        return self.data

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify(self.data, msg, sig)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Secp256k1PubKey) and self.data == other.data
        )

    def __hash__(self) -> int:
        return hash((SECP256K1_KEY_TYPE, self.data))


@dataclass(frozen=True, slots=True)
class Secp256k1PrivKey:
    data: bytes  # 32-byte big-endian scalar

    def __post_init__(self) -> None:
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("secp256k1 privkey must be 32 bytes")

    @classmethod
    def from_seed(cls, seed: bytes) -> "Secp256k1PrivKey":
        v = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (_N - 1) + 1
        return cls(v.to_bytes(32, "big"))

    @property
    def type(self) -> str:
        return SECP256K1_KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def sign(self, msg: bytes) -> bytes:
        return sign(self.data, msg)

    def pub_key(self) -> Secp256k1PubKey:
        return Secp256k1PubKey(public_key(self.data))
