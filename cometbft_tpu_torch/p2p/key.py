"""Node identity (reference: p2p/key.go).

A node's ID is the hex of its ed25519 pubkey address (20 bytes); the key
persists in ``node_key.json``.
"""

from __future__ import annotations

import json
import os

from ..crypto.keys import Ed25519PrivKey


def node_id_from_pubkey(pub_key) -> str:
    return bytes(pub_key.address()).hex()


class NodeKey:
    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @property
    def node_id(self) -> str:
        return node_id_from_pubkey(self.priv_key.pub_key())

    def pub_key(self):
        return self.priv_key.pub_key()

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            return cls(Ed25519PrivKey.from_seed(bytes.fromhex(d["priv_key"])))
        nk = cls(Ed25519PrivKey.generate())
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({"priv_key": nk.priv_key.seed.hex()}, f)
        return nk
