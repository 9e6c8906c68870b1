"""AEAD helpers + ASCII armor (reference: crypto/xchacha20poly1305,
crypto/xsalsa20symmetric, crypto/armor), and the IETF ChaCha20-Poly1305
that seals the secret connection's frames (p2p/conn/secret_connection).

Port of cometbft_tpu/crypto/aead.py. ``new_chacha20poly1305`` keeps the
reference's first choice, the ``cryptography`` wheel's OpenSSL cipher when
the wheel imports. Without the wheel it returns
:class:`ChaCha20Poly1305Native`, the same RFC 8439 function compiled from
``native/chacha20poly1305.cpp`` by g++ (libs/native_build, into
``build/native/``): a failed build or load raises ``NativeBuildError`` and
nothing falls back to the pure-Python construction. That construction,
:class:`ChaCha20Poly1305Fallback`, stays as the plain version the tests
hold the native tier against (~4.5 ms a 1 KiB frame on a CPU core).

XChaCha20-Poly1305: HChaCha20 subkey derivation (pure-Python ChaCha
core) over the IETF ChaCha20-Poly1305 above. XSalsa20: pure-Python
Salsa20 core with the classic HSalsa20 key setup, the raw stream cipher
the legacy decoder needs; ``encrypt_symmetric`` is the modern
authenticated construction (XChaCha) in EncryptSymmetric's role.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

from ..libs import native_build
from ..libs import sync as libsync

try:  # the cryptography wheel (OpenSSL) is the first choice
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover
    _HAVE_CRYPTOGRAPHY = False

# ------------------------------------------------------------- chacha core


def _rotl(v: int, n: int) -> int:
    v &= 0xFFFFFFFF
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _chacha_quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl(s[b] ^ s[c], 7)


_CHACHA_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha_rounds(state: list[int]) -> list[int]:
    s = list(state)
    for _ in range(10):  # 20 rounds = 10 double rounds
        _chacha_quarter(s, 0, 4, 8, 12)
        _chacha_quarter(s, 1, 5, 9, 13)
        _chacha_quarter(s, 2, 6, 10, 14)
        _chacha_quarter(s, 3, 7, 11, 15)
        _chacha_quarter(s, 0, 5, 10, 15)
        _chacha_quarter(s, 1, 6, 11, 12)
        _chacha_quarter(s, 2, 7, 8, 13)
        _chacha_quarter(s, 3, 4, 9, 14)
    return s


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2)."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20 needs 32-byte key, 16-byte nonce")
    state = list(_CHACHA_CONST)
    state += list(struct.unpack("<8L", key))
    state += list(struct.unpack("<4L", nonce16))
    s = _chacha_rounds(state)
    out = s[0:4] + s[12:16]
    return struct.pack("<8L", *out)


# ------------------------------------------- chacha20-poly1305 (RFC 8439)
# Pure-Python IETF AEAD over the chacha core above: the plain version of
# the native tier below (byte-equal on every input the tests draw).


def _chacha20_block(key: bytes, counter: int, nonce12: bytes) -> bytes:
    state = list(_CHACHA_CONST)
    state += list(struct.unpack("<8L", key))
    state.append(counter & 0xFFFFFFFF)
    state += list(struct.unpack("<3L", nonce12))
    s = _chacha_rounds(state)
    return struct.pack(
        "<16L", *((a + b) & 0xFFFFFFFF for a, b in zip(s, state))
    )


def chacha20_stream_xor(
    key: bytes, counter: int, nonce12: bytes, data: bytes
) -> bytes:
    if len(key) != 32 or len(nonce12) != 12:
        raise ValueError("chacha20 needs 32-byte key, 12-byte nonce")
    out = bytearray()
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce12)
        chunk = data[i : i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, block))
    return bytes(out)


def poly1305_mac(key32: bytes, msg: bytes) -> bytes:
    r = (
        int.from_bytes(key32[:16], "little")
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    )
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block, "little") + (1 << (8 * len(block)))
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _mac_data(aad: bytes, ct: bytes) -> bytes:
    return (
        aad
        + _pad16(aad)
        + ct
        + _pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )


class ChaCha20Poly1305Fallback:
    """Drop-in for the wheel's ChaCha20Poly1305 (encrypt/decrypt API)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("chacha20poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = aad or b""
        otk = _chacha20_block(self._key, 0, nonce)[:32]
        ct = chacha20_stream_xor(self._key, 1, nonce, data)
        return ct + poly1305_mac(otk, _mac_data(aad, ct))

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        import hmac as _hmac

        aad = aad or b""
        if len(data) < 16:
            raise ValueError("ciphertext shorter than the poly1305 tag")
        ct, tag = data[:-16], data[-16:]
        otk = _chacha20_block(self._key, 0, nonce)[:32]
        if not _hmac.compare_digest(
            tag, poly1305_mac(otk, _mac_data(aad, ct))
        ):
            raise ValueError("poly1305 tag mismatch")
        return chacha20_stream_xor(self._key, 1, nonce, ct)


NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / (
    "chacha20poly1305.cpp")

_load_lock = libsync.Mutex("crypto.aead._build_lock")
_lib = None


def _load_native():
    """The native cipher, built and bound at first use; raises
    NativeBuildError when it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = native_build.build_and_load(NATIVE_SRC)
            for fn in (lib.cp_seal, lib.cp_open):
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_char_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


class ChaCha20Poly1305Native:
    """RFC 8439 ChaCha20-Poly1305 in native/chacha20poly1305.cpp, with the
    wheel's encrypt/decrypt contract (a 12-byte nonce; decrypt raises
    ValueError on a bad tag, as the plain version does)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("chacha20poly1305 key must be 32 bytes")
        self._lib = _load_native()
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = bytes(aad or b"")
        data = bytes(data)
        if len(nonce) != 12:
            raise ValueError("chacha20poly1305 nonce must be 12 bytes")
        out = ctypes.create_string_buffer(len(data) + 16)
        self._lib.cp_seal(self._key, bytes(nonce), aad, len(aad), data,
                          len(data), out)
        return out.raw

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        aad = bytes(aad or b"")
        data = bytes(data)
        if len(nonce) != 12:
            raise ValueError("chacha20poly1305 nonce must be 12 bytes")
        if len(data) < 16:
            raise ValueError("ciphertext shorter than the poly1305 tag")
        out = ctypes.create_string_buffer(len(data) - 16)
        if self._lib.cp_open(self._key, bytes(nonce), aad, len(aad), data,
                             len(data), out) != 0:
            raise ValueError("poly1305 tag mismatch")
        return out.raw


def new_chacha20poly1305(key: bytes):
    """IETF ChaCha20-Poly1305: OpenSSL via the wheel when it imports, the
    native tier otherwise (never the pure-Python construction)."""
    if _HAVE_CRYPTOGRAPHY:
        return ChaCha20Poly1305(key)
    return ChaCha20Poly1305Native(key)


def xchacha20poly1305_encrypt(
    key: bytes, nonce24: bytes, plaintext: bytes, aad: bytes = b""
) -> bytes:
    """XChaCha20-Poly1305 seal (crypto/xchacha20poly1305 semantics)."""
    if len(nonce24) != 24:
        raise ValueError("xchacha nonce must be 24 bytes")
    subkey = hchacha20(key, nonce24[:16])
    iv = b"\x00" * 4 + nonce24[16:]
    return new_chacha20poly1305(subkey).encrypt(iv, plaintext, aad)


def xchacha20poly1305_decrypt(
    key: bytes, nonce24: bytes, ciphertext: bytes, aad: bytes = b""
) -> bytes:
    if len(nonce24) != 24:
        raise ValueError("xchacha nonce must be 24 bytes")
    subkey = hchacha20(key, nonce24[:16])
    iv = b"\x00" * 4 + nonce24[16:]
    return new_chacha20poly1305(subkey).decrypt(iv, ciphertext, aad)


# ------------------------------------------------------------- salsa core


def _salsa_quarter(s, a, b, c, d):
    s[b] ^= _rotl((s[a] + s[d]) & 0xFFFFFFFF, 7)
    s[c] ^= _rotl((s[b] + s[a]) & 0xFFFFFFFF, 9)
    s[d] ^= _rotl((s[c] + s[b]) & 0xFFFFFFFF, 13)
    s[a] ^= _rotl((s[d] + s[c]) & 0xFFFFFFFF, 18)


_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _salsa20_block(key32: bytes, nonce8: bytes, counter: int) -> bytes:
    k = struct.unpack("<8L", key32)
    n = struct.unpack("<2L", nonce8)
    state = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        counter & 0xFFFFFFFF, (counter >> 32) & 0xFFFFFFFF,
        _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    s = list(state)
    for _ in range(10):
        # column rounds
        _salsa_quarter(s, 0, 4, 8, 12)
        _salsa_quarter(s, 5, 9, 13, 1)
        _salsa_quarter(s, 10, 14, 2, 6)
        _salsa_quarter(s, 15, 3, 7, 11)
        # row rounds
        _salsa_quarter(s, 0, 1, 2, 3)
        _salsa_quarter(s, 5, 6, 7, 4)
        _salsa_quarter(s, 10, 11, 8, 9)
        _salsa_quarter(s, 15, 12, 13, 14)
    out = [(s[i] + state[i]) & 0xFFFFFFFF for i in range(16)]
    return struct.pack("<16L", *out)


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """HSalsa20 (NaCl's XSalsa20 key setup)."""
    k = struct.unpack("<8L", key)
    n = struct.unpack("<4L", nonce16)
    s = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        n[2], n[3], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    z = list(s)
    for _ in range(10):
        _salsa_quarter(z, 0, 4, 8, 12)
        _salsa_quarter(z, 5, 9, 13, 1)
        _salsa_quarter(z, 10, 14, 2, 6)
        _salsa_quarter(z, 15, 3, 7, 11)
        _salsa_quarter(z, 0, 1, 2, 3)
        _salsa_quarter(z, 5, 6, 7, 4)
        _salsa_quarter(z, 10, 11, 8, 9)
        _salsa_quarter(z, 15, 12, 13, 14)
    out = [z[0], z[5], z[10], z[15], z[6], z[7], z[8], z[9]]
    return struct.pack("<8L", *out)


def xsalsa20_stream_xor(key: bytes, nonce24: bytes, data: bytes) -> bytes:
    """XSalsa20 stream XOR (crypto/xsalsa20symmetric's cipher layer)."""
    if len(key) != 32 or len(nonce24) != 24:
        raise ValueError("xsalsa20 needs 32-byte key, 24-byte nonce")
    subkey = hsalsa20(key, nonce24[:16])
    out = bytearray()
    counter = 0
    for i in range(0, len(data), 64):
        block = _salsa20_block(subkey, nonce24[16:], counter)
        chunk = data[i : i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, block))
        counter += 1
    return bytes(out)


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """Authenticated symmetric encryption for key files
    (crypto/xsalsa20symmetric EncryptSymmetric's role, modern AEAD):
    random 24-byte nonce || XChaCha20-Poly1305 box."""
    import os

    if len(secret) != 32:
        raise ValueError("secret must be 32 bytes (use a KDF)")
    nonce = os.urandom(24)
    return nonce + xchacha20poly1305_encrypt(secret, nonce, plaintext)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    if len(secret) != 32:
        raise ValueError("secret must be 32 bytes (use a KDF)")
    if len(ciphertext) < 24 + 16:
        raise ValueError("ciphertext too short")
    return xchacha20poly1305_decrypt(
        secret, ciphertext[:24], ciphertext[24:]
    )


# ---------------------------------------------------------------- armor


_ARMOR_HEAD = "-----BEGIN {}-----"
_ARMOR_TAIL = "-----END {}-----"


def _crc24(data: bytes) -> int:
    """OpenPGP CRC-24 (RFC 4880 §6.1)."""
    crc = 0xB704CE
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= 0x1864CFB
    return crc & 0xFFFFFF


def armor_encode(
    data: bytes, block_type: str, headers: dict[str, str] | None = None
) -> str:
    """ASCII armor (crypto/armor.EncodeArmor; OpenPGP-style framing)."""
    import base64
    import textwrap

    lines = [_ARMOR_HEAD.format(block_type)]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    lines.append("")
    body = base64.b64encode(data).decode()
    lines.extend(textwrap.wrap(body, 64))
    crc = base64.b64encode(struct.pack(">I", _crc24(data))[1:]).decode()
    lines.append("=" + crc)
    lines.append(_ARMOR_TAIL.format(block_type))
    return "\n".join(lines) + "\n"


def armor_decode(text: str) -> tuple[str, dict[str, str], bytes]:
    """-> (block_type, headers, data); raises ValueError on bad framing/CRC."""
    import base64

    lines = [ln.strip() for ln in text.strip().splitlines()]
    if not lines or not lines[0].startswith("-----BEGIN "):
        raise ValueError("missing armor header")
    block_type = lines[0][len("-----BEGIN ") : -5]
    if lines[-1] != _ARMOR_TAIL.format(block_type):
        raise ValueError("missing/mismatched armor tail")
    headers: dict[str, str] = {}
    i = 1
    while i < len(lines) - 1 and lines[i]:
        if ":" not in lines[i]:
            break
        k, _, v = lines[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(lines) and not lines[i]:
        i += 1
    body_lines = []
    crc_line = None
    for ln in lines[i:-1]:
        if ln.startswith("="):
            crc_line = ln[1:]
        elif ln:
            body_lines.append(ln)
    data = base64.b64decode("".join(body_lines))
    if crc_line is not None:
        want = base64.b64decode(crc_line)
        got = struct.pack(">I", _crc24(data))[1:]
        if want != got:
            raise ValueError("armor CRC mismatch")
    return block_type, headers, data
