"""RFC-6962 merkle tree, proofs, and proof-operator chaining.

Port of cometbft_tpu/crypto/merkle.py (reference: crypto/merkle/tree.go
HashFromByteSlices, proof.go Proof and ProofsFromByteSlices, proof_op.go).
Domain separation: leaf = SHA256(0x00 || item), inner = SHA256(0x01 || l ||
r); the empty tree hashes to SHA256("").

The tree is walked level by level: adjacent nodes pair up and an odd tail
node is promoted unchanged, which yields the reference's largest-power-of-
two split tree without recursing. Each level is one flat batch through
crypto/hashplane.hash_many, so a routed hash plane takes the levels that
can win on the device and hashlib the rest; a single leaf goes through
hashplane.hash_bytes. Digests are the same either way.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import devledger
from . import hashplane, tmhash

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _leaf_hash(item: bytes) -> bytes:
    # a 64 KiB PartSet leaf coalesces into a device window when a plane is
    # routed; small leaves take hashlib. The ledger's default tenant is
    # "merkle"; an outer declaration wins.
    with devledger.caller_class("merkle"):
        return hashplane.hash_bytes(LEAF_PREFIX + item)


def _inner_hash(left: bytes, right: bytes) -> bytes:
    return tmhash.sum(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (RFC 6962 split)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def _compute_levels(items: list[bytes]) -> list[list[bytes]]:
    """All tree levels bottom-up: level 0 the leaf hashes, the last [root].
    Each level pairs adjacent nodes; an odd tail node is promoted. Charged
    to the "merkle" caller class unless an outer caller declared one."""
    with devledger.caller_class("merkle"):
        level = hashplane.hash_many([LEAF_PREFIX + bytes(x) for x in items])
        levels = [level]
        while len(level) > 1:
            nxt = hashplane.hash_many([
                INNER_PREFIX + level[i] + level[i + 1]
                for i in range(0, len(level) - 1, 2)
            ])
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
            levels.append(level)
    return levels


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Root hash of the RFC-6962 tree over ``items``."""
    if not items:
        return tmhash.sum(b"")
    return _compute_levels(items)[-1][0]


@dataclass(slots=True)
class Proof:
    """Inclusion proof for item ``index`` of ``total`` (crypto/merkle/proof.go)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    def compute_root_hash(self) -> bytes | None:
        return _root_from_aunts(self.index, self.total, self.leaf_hash,
                                self.aunts)

    def verify(self, root_hash: bytes, leaf: bytes) -> None:
        if self.total < 0 or self.index < 0:
            raise ValueError("proof total/index must be non-negative")
        if _leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("leaf hash mismatch")
        if self.compute_root_hash() != root_hash:
            raise ValueError("invalid merkle proof")


def _root_from_aunts(index: int, total: int, leaf: bytes,
                     aunts: list[bytes]) -> bytes | None:
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _root_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return _inner_hash(left, aunts[-1])
    right = _root_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return _inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """(root, per-item proofs), crypto/merkle/proof.go ProofsFromByteSlices.

    Built from the levels: leaf i's aunt at each level is its pair sibling
    (``idx ^ 1``) when one exists (a promoted odd tail has none there),
    and ``idx //= 2`` maps to the parent either way. Aunts run leaf to
    root, the order ``_root_from_aunts`` consumes from the end.
    """
    if not items:
        return tmhash.sum(b""), []
    levels = _compute_levels(items)
    total = len(items)
    proofs = []
    for i in range(total):
        aunts: list[bytes] = []
        idx = i
        for level in levels[:-1]:
            sib = idx ^ 1
            if sib < len(level):
                aunts.append(level[sib])
            idx //= 2
        proofs.append(Proof(total=total, index=i, leaf_hash=levels[0][i],
                            aunts=aunts))
    return levels[-1][0], proofs


# --- Proof operators (crypto/merkle/proof_op.go) -----------------------------


class ProofOperator:
    """One verification step: maps child value(s) -> parent value."""

    def run(self, values: list[bytes]) -> list[bytes]:
        raise NotImplementedError

    def get_key(self) -> bytes:
        raise NotImplementedError


@dataclass(slots=True)
class ValueOp(ProofOperator):
    """Leaf-value op: proves SHA256(value)'s inclusion under a root."""

    key: bytes
    proof: Proof

    def run(self, values: list[bytes]) -> list[bytes]:
        if len(values) != 1:
            raise ValueError("ValueOp expects one value")
        vhash = tmhash.sum(values[0])
        if _leaf_hash(vhash) != self.proof.leaf_hash:
            raise ValueError("leaf mismatch")
        root = self.proof.compute_root_hash()
        if root is None:
            raise ValueError("bad proof shape")
        return [root]

    def get_key(self) -> bytes:
        return self.key


class ProofOperators(list):
    """Chain of operators verified leaf -> root (proof_op.go Verify)."""

    def verify_value(self, root: bytes, keypath: list[bytes],
                     value: bytes) -> None:
        self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: list[bytes],
               args: list[bytes]) -> None:
        keys = list(keypath)
        for op in self:
            key = op.get_key()
            if key:
                if not keys or keys[-1] != key:
                    raise ValueError(f"key mismatch on {key!r}")
                keys.pop()
            args = op.run(args)
        if args[0] != root:
            raise ValueError("computed root does not match")
        if keys:
            raise ValueError("keypath not fully consumed")
