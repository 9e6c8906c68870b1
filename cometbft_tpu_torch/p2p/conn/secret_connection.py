"""Authenticated encryption handshake + framing (reference:
p2p/conn/secret_connection.go:63-120).

Station-to-Station protocol:
1. exchange ephemeral X25519 pubkeys (unencrypted, 32B each);
2. ECDH → HKDF-SHA256 (secret_connection.go:335) expands 96 bytes: two
   ChaCha20-Poly1305 keys (low/high by ephemeral key order) + a 32-byte
   challenge;
3. each side signs the challenge with its persistent ed25519 key and
   sends (pubkey, sig) over the now-encrypted link (:389);
4. all traffic flows in sealed frames: 4-byte LE length + payload padded
   to 1024 bytes, 16-byte Poly1305 tag; 96-bit little-endian counter
   nonces (:453).

Port of cometbft_tpu/p2p/conn/secret_connection.py. The frames' cipher
comes from crypto/aead.new_chacha20poly1305: the wheel's OpenSSL when it
imports, else the native RFC 8439 tier (never the pure-Python
construction, ~4.5 ms a frame). X25519 and HKDF keep the reference's
pure-Python fallback: they run once a handshake.
"""

from __future__ import annotations

import os
import struct
from ...libs import sync as libsync

try:  # the cryptography wheel (OpenSSL) is preferred; without it the
    # handshake runs the package's pure-Python X25519/HKDF below and the
    # frames the native ChaCha20-Poly1305 (crypto/aead) — same RFCs,
    # interoperable across the paths.
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover
    _HAVE_CRYPTOGRAPHY = False

from ...crypto import x25519 as x25519_fallback
from ...crypto.aead import new_chacha20poly1305
from ...crypto.keys import Ed25519PubKey

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + TAG_SIZE

HKDF_INFO = b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"
CHALLENGE_CONTEXT = b"TENDERMINT_SECRET_CONNECTION_KEY_CHALLENGE"


class SecretConnectionError(Exception):
    pass


def _x25519_keypair():
    """(opaque private handle, 32-byte public key)."""
    if _HAVE_CRYPTOGRAPHY:
        priv = X25519PrivateKey.generate()
        return priv, priv.public_key().public_bytes_raw()
    seed = os.urandom(32)
    return seed, x25519_fallback.x25519_base(seed)


def _x25519_exchange(priv, remote_pub: bytes) -> bytes:
    if _HAVE_CRYPTOGRAPHY:
        return priv.exchange(X25519PublicKey.from_public_bytes(remote_pub))
    shared = x25519_fallback.x25519(priv, remote_pub)
    if shared == bytes(32):
        # low-order remote point: the whole "shared" secret is attacker-
        # known. OpenSSL's exchange() raises here; match it exactly so
        # wheel-less nodes reject the same peers wheel-backed ones do.
        raise SecretConnectionError("x25519: low-order remote ephemeral key")
    return shared


def hkdf_sha256(
    ikm: bytes, info: bytes, length: int, salt: bytes = b"\x00" * 32
) -> bytes:
    """RFC 5869 HKDF-SHA256 (pure, stdlib hmac). Default salt is the
    RFC's not-provided case (HashLen zeros)."""
    import hashlib
    import hmac

    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def _hkdf_sha256_96(shared: bytes) -> bytes:
    """HKDF-SHA256(salt=None, info=HKDF_INFO) -> 96 bytes."""
    if _HAVE_CRYPTOGRAPHY:
        return HKDF(
            algorithm=hashes.SHA256(),
            length=96,
            salt=None,
            info=HKDF_INFO,
        ).derive(shared)
    return hkdf_sha256(shared, HKDF_INFO, 96)


class _Nonce:
    """96-bit LE counter nonce (secret_connection.go:446-458)."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def next(self) -> bytes:
        out = b"\x00\x00\x00\x00" + struct.pack("<Q", self.n)
        self.n += 1
        if self.n >= 1 << 64:
            raise SecretConnectionError("nonce wrapped")
        return out


class SecretConnection:
    """Wraps a socket-like object (needs sendall/recv) post-handshake."""

    def __init__(self, sock, priv_key):
        """priv_key: our persistent ed25519 key (node key)."""
        self._sock = sock
        self._send_mtx = libsync.Mutex("p2p.conn.secret_connection._send_mtx")
        self._recv_mtx = libsync.Mutex("p2p.conn.secret_connection._recv_mtx")
        self._recv_buf = b""

        # 1. ephemeral key exchange
        eph_priv, eph_pub = _x25519_keypair()
        self._write_all(eph_pub)
        remote_eph = self._read_exact(32)

        # 2. shared secret → keys + challenge
        shared = _x25519_exchange(eph_priv, remote_eph)
        okm = _hkdf_sha256_96(shared)
        # Key order: the side with the smaller ephemeral pubkey uses okm[:32]
        # to receive (secret_connection.go:312-333).
        loc_is_least = eph_pub < remote_eph
        if loc_is_least:
            recv_key, send_key = okm[:32], okm[32:64]
        else:
            send_key, recv_key = okm[:32], okm[32:64]
        challenge = okm[64:96]
        self._send_aead = new_chacha20poly1305(send_key)
        self._recv_aead = new_chacha20poly1305(recv_key)
        self._send_nonce = _Nonce()
        self._recv_nonce = _Nonce()

        # 3. authenticate: sign challenge, swap (pubkey, sig) encrypted
        sig = priv_key.sign(CHALLENGE_CONTEXT + challenge)
        self.write(priv_key.pub_key().bytes() + sig)
        auth = self.read_exact_msg(32 + 64)
        remote_pub_bytes, remote_sig = auth[:32], auth[32:]
        self.remote_pub_key = Ed25519PubKey(remote_pub_bytes)
        if not self.remote_pub_key.verify_signature(
            CHALLENGE_CONTEXT + challenge, remote_sig
        ):
            raise SecretConnectionError("challenge signature invalid")

    # -- raw io ------------------------------------------------------------

    def _write_all(self, data: bytes) -> None:
        self._sock.sendall(data)

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise EOFError("secret connection closed")
            out += chunk
        return out

    # -- sealed framing ----------------------------------------------------

    def write(self, data: bytes) -> int:
        """Encrypt+send; fragments into 1024-byte frames."""
        n = 0
        with self._send_mtx:  # cometlint: disable=CLNT009 -- send mutex pairs the AEAD nonce sequence with socket order
            for i in range(0, max(len(data), 1), DATA_MAX_SIZE):
                chunk = data[i : i + DATA_MAX_SIZE]
                frame = struct.pack("<I", len(chunk)) + chunk
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                sealed = self._send_aead.encrypt(
                    self._send_nonce.next(), frame, None
                )
                self._write_all(sealed)
                n += len(chunk)
        return n

    def _read_frame(self) -> bytes:
        sealed = self._read_exact(SEALED_FRAME_SIZE)
        try:
            frame = self._recv_aead.decrypt(
                self._recv_nonce.next(), sealed, None
            )
        except Exception as e:
            raise SecretConnectionError(f"frame decryption failed: {e}") from e
        (length,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if length > DATA_MAX_SIZE:
            raise SecretConnectionError("frame length corrupt")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length]

    def read(self, n: int) -> bytes:
        """Read up to n plaintext bytes (at least 1)."""
        with self._recv_mtx:  # cometlint: disable=CLNT009 -- recv mutex pairs the AEAD nonce sequence with socket reads
            if not self._recv_buf:
                self._recv_buf = self._read_frame()
            out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
            return out

    def read_exact_msg(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += self.read(n - len(out))
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
