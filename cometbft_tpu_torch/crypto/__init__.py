"""Crypto: ed25519 keys and oracle, hashing, merkle, batch dispatch."""
