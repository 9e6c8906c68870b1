"""Key types: ed25519 (validator keys), the PubKey/PrivKey contracts and
the registry of every key type.

Reference surface: crypto/crypto.go:22-54 (PubKey, PrivKey), with the
ed25519 semantics of crypto/ed25519/ed25519.go — ZIP-215 verification,
SHA-256[:20] addresses, and a 64-byte private key laid out as
seed || pubkey (RFC 8032 / golang crypto/ed25519).

Single signatures verify, sign and derive keys on the host through
crypto/fast25519 (OpenSSL where the ``cryptography`` wheel is installed,
the native engine, the exact ZIP-215 oracle on a reject); batches go to
the device through crypto/batch. sr25519 (crypto/sr25519.py) and
secp256k1 (crypto/secp256k1.py) register in :data:`PUBKEY_TYPES` when the
crypto package is imported (:func:`register_extra_key_types`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import tmhash

ED25519_KEY_TYPE = "ed25519"
SECP256K1_KEY_TYPE = "secp256k1"
SR25519_KEY_TYPE = "sr25519"

PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey


class Address(bytes):
    """20-byte account/validator address (SHA-256 truncated)."""

    def __str__(self) -> str:  # uppercase hex like the reference's HexBytes
        return self.hex().upper()


@dataclass(frozen=True, slots=True)
class Ed25519PubKey:
    data: bytes  # 32-byte compressed point

    def __post_init__(self) -> None:
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("ed25519 pubkey must be 32 bytes")

    @property
    def type(self) -> str:
        return ED25519_KEY_TYPE

    def address(self) -> Address:
        return Address(tmhash.sum_truncated(self.data))

    def bytes(self) -> bytes:
        return self.data

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """Single-signature ZIP-215 verification on the host
        (crypto/fast25519.verify_one)."""
        from . import fast25519

        return fast25519.verify_one(self.data, msg, sig)


@dataclass(frozen=True, slots=True)
class Ed25519PrivKey:
    data: bytes  # seed || pubkey (64 bytes)

    def __post_init__(self) -> None:
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("ed25519 privkey must be 64 bytes (seed||pub)")

    @classmethod
    def generate(cls, rng=os.urandom) -> "Ed25519PrivKey":
        return cls.from_seed(rng(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "Ed25519PrivKey":
        from . import fast25519

        return cls(seed + fast25519.pubkey_from_seed(seed))

    @property
    def type(self) -> str:
        return ED25519_KEY_TYPE

    @property
    def seed(self) -> bytes:
        return self.data[:32]

    def bytes(self) -> bytes:
        return self.data

    def sign(self, msg: bytes) -> bytes:
        from . import fast25519

        return fast25519.sign_one(self.seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self.data[32:])


# Registry used by serialization and the batch dispatch
# (crypto/batch/batch.go:11). sr25519 and secp256k1 register from the
# crypto package's __init__, which keeps import cycles out of this module.
PUBKEY_TYPES: dict[str, type] = {ED25519_KEY_TYPE: Ed25519PubKey}


def register_extra_key_types() -> None:
    from .secp256k1 import Secp256k1PubKey
    from .sr25519 import Sr25519PubKey

    PUBKEY_TYPES.setdefault(SR25519_KEY_TYPE, Sr25519PubKey)
    PUBKEY_TYPES.setdefault(SECP256K1_KEY_TYPE, Secp256k1PubKey)


def pubkey_from_type_and_bytes(key_type: str, data: bytes):
    cls = PUBKEY_TYPES.get(key_type)
    if cls is None:
        raise ValueError(f"unknown pubkey type {key_type!r}")
    return cls(data)
