"""Fast host-side ed25519 single verification and signing with exact
ZIP-215 semantics.

The device owns large batches (ops/verify.py), but a single signature
(a proposal, a handshake challenge, an evidence check, an inline lane of
a commit walk) is cheaper on the host. This is the host path CometBFT
gets from curve25519-voi (crypto/ed25519/ed25519.go:168), in three tiers:

1. OpenSSL through the ``cryptography`` wheel, when it is installed.
   OpenSSL checks the cofactorless RFC 8032 equation, which accepts a
   SUBSET of ZIP-215 (multiply it by 8): its accept is final.
2. The native engine (crypto/host_batch.py, native/edbatch.cpp) at one
   lane: the cofactored equation with ZIP-215 decoding. Its accept is
   final (sound but for a 2^-128 coefficient draw).
3. The exact ZIP-215 oracle (ed25519_ref) on every reject of the tiers
   above, so the verdict always equals the oracle's: honest signatures
   never reach it, adversarial edge encodings pay its ~2 ms.

Which tiers run depends on what is installed, probed once at import
(:data:`HAVE_OPENSSL`); the verdicts do not. An error inside a tier that
runs propagates: OpenSSL's parse refusal of a key ZIP-215 still admits is
a reject (tier 2 takes over), not an error, and the native engine builds
or raises as it does everywhere.

Signing and key derivation are deterministic in (seed, msg), so OpenSSL
and the oracle give identical bytes: with the wheel they run on OpenSSL,
without it on the oracle.
"""

from __future__ import annotations

from functools import lru_cache

from . import ed25519_ref as ref
from . import host_batch

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
except ImportError:
    HAVE_OPENSSL = False
else:
    HAVE_OPENSSL = True


def tier() -> str:
    """The first tier of :func:`verify_one` in this process: "openssl"
    with the wheel, else "native"."""
    return "openssl" if HAVE_OPENSSL else "native"


@lru_cache(maxsize=4096)
def _loaded_key(pubkey: bytes):
    """The parsed OpenSSL key, LRU-cached like the reference engine's
    4096-entry expanded-key cache (crypto/ed25519/ed25519.go:31,56); None
    for an encoding OpenSSL refuses to parse."""
    try:
        return Ed25519PublicKey.from_public_bytes(pubkey)
    except ValueError:
        return None


def verify_one(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification of one signature: the tiers of the module
    docstring, the first accept final, a reject re-checked by the
    oracle."""
    pubkey, msg, sig = bytes(pubkey), bytes(msg), bytes(sig)
    if len(pubkey) == 32 and len(sig) == 64:
        if HAVE_OPENSSL:
            key = _loaded_key(pubkey)
            if key is not None:
                try:
                    key.verify(sig, msg)
                    return True  # RFC 8032-valid implies ZIP-215-valid
                except InvalidSignature:
                    pass  # may still be ZIP-215-valid
        if host_batch.verify_many([pubkey], [msg], [sig])[0]:
            return True
    return ref.verify(pubkey, msg, sig)


def sign_one(seed: bytes, msg: bytes) -> bytes:
    """Deterministic RFC 8032 signature of ``msg`` under ``seed``."""
    if HAVE_OPENSSL and len(seed) == 32:
        return Ed25519PrivateKey.from_private_bytes(bytes(seed)).sign(
            bytes(msg))
    return ref.sign(bytes(seed), bytes(msg))


def pubkey_from_seed(seed: bytes) -> bytes:
    """The 32-byte public key of ``seed``."""
    if HAVE_OPENSSL and len(seed) == 32:
        return Ed25519PrivateKey.from_private_bytes(
            bytes(seed)).public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw)
    return ref.pubkey_from_seed(bytes(seed))


def verify_many(pubkeys, msgs, sigs) -> list[bool]:
    """:func:`verify_one` on each lane in turn."""
    return [verify_one(p, m, s) for p, m, s in zip(pubkeys, msgs, sigs)]
