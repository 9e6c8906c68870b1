"""Pure-Python X25519 (RFC 7748): the key exchange of the p2p
secret-connection handshake when the ``cryptography`` wheel is absent.

Port of cometbft_tpu/crypto/x25519.py, line for line. One ladder
evaluation is ~2.7 ms of bigint work on a CPU core; the handshake runs it
twice a connection, so it stays in Python (p2p/conn/secret_connection.py
prefers the wheel's OpenSSL when it imports).
"""

from __future__ import annotations

_P = 2**255 - 19
_A24 = 121665


def _decode_u(u: bytes) -> int:
    if len(u) != 32:
        raise ValueError("x25519 u-coordinate must be 32 bytes")
    x = bytearray(u)
    x[31] &= 127  # RFC 7748 §5: mask the unused high bit
    return int.from_bytes(x, "little") % _P


def _decode_scalar(k: bytes) -> int:
    if len(k) != 32:
        raise ValueError("x25519 scalar must be 32 bytes")
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519(scalar: bytes, u: bytes) -> bytes:
    """Montgomery-ladder scalar multiplication (RFC 7748 §5)."""
    k = _decode_scalar(scalar)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def x25519_base(scalar: bytes) -> bytes:
    """Public key for a 32-byte private scalar (u = 9 base point)."""
    return x25519(scalar, (9).to_bytes(32, "little"))
