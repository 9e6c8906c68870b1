"""Crypto: ed25519, sr25519 and secp256k1 keys, the ed25519 oracle,
hashing, merkle, batch dispatch."""

# sr25519 and secp256k1 register here (not in keys.py) to keep import
# cycles out while every entry point that imports the package sees them.
from .keys import register_extra_key_types as _register_extra

_register_extra()
