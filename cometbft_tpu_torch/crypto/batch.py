"""Batch-verification dispatch: key type -> batch verifier backend.

Reference surface: crypto/crypto.go:45-54 (BatchVerifier interface) and
crypto/batch/batch.go:11-32 (CreateBatchVerifier / SupportsBatchVerifier).

The ed25519 backend accumulates (pubkey, msg, sig) triples on the host
and verifies them in one device pass (ops/verify.verify_batch). Every
batch goes to the device: this package has no host batch path.
"""

from __future__ import annotations

import numpy as np

from . import keys
from .keys import Ed25519PubKey


class BatchVerifier:
    """Add/Verify contract of crypto.BatchVerifier (crypto/crypto.go:45-54).

    ``verify`` returns (all_valid, per_signature_validity); per-lane results
    let callers name the failing signature without a second pass.
    """

    def add(self, pub_key, msg: bytes, signature: bytes) -> None:
        raise NotImplementedError

    def verify(self) -> tuple[bool, list[bool]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class Ed25519BatchVerifier(BatchVerifier):
    """ed25519 batch verification on ``device`` (default the GPU).

    ``pubkey_cache`` (an ops.verify.PubkeyTableCache on the same device)
    routes the batch through the cached kernel; None runs the uncached one.
    ``flavor`` picks the kernels' flavor (ops.verify.kernel_flavor: "4",
    "8", or None for COMETBFT_TPU_KERNEL read when the batch verifies).
    """

    def __init__(self, device="cuda", pubkey_cache=None, flavor=None) -> None:
        self.device = device
        self.pubkey_cache = pubkey_cache
        self.flavor = flavor
        self._pubkeys: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, pub_key, msg: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, Ed25519PubKey):
            raise TypeError("Ed25519BatchVerifier requires ed25519 keys")
        self._pubkeys.append(pub_key.data)
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(signature))

    def __len__(self) -> int:
        return len(self._pubkeys)

    def verify(self) -> tuple[bool, list[bool]]:
        from ..ops import verify as ov

        ok_all, bitmap = ov.verify_batch(
            self._pubkeys, self._msgs, self._sigs,
            device=self.device, cache=self.pubkey_cache, flavor=self.flavor,
        )
        return ok_all, list(np.asarray(bitmap, bool))


_BATCH_BACKENDS: dict[str, type] = {
    keys.ED25519_KEY_TYPE: Ed25519BatchVerifier,
}


def supports_batch_verifier(pub_key) -> bool:
    return getattr(pub_key, "type", None) in _BATCH_BACKENDS


def supports_commit_batch(validator_set) -> bool:
    """True when every key type in the set has a batch backend."""
    vals = getattr(validator_set, "validators", [])
    return bool(vals) and all(supports_batch_verifier(v.pub_key) for v in vals)


def create_batch_verifier(pub_key, device="cuda", pubkey_cache=None,
                          flavor=None) -> BatchVerifier:
    """The batch backend for ``pub_key``'s type; ValueError for types
    without one (callers verify singly, types/validation.go:170-176)."""
    backend = _BATCH_BACKENDS.get(getattr(pub_key, "type", None))
    if backend is None:
        raise ValueError(
            f"batch verification unsupported for key type "
            f"{getattr(pub_key, 'type', None)!r}"
        )
    return backend(device=device, pubkey_cache=pubkey_cache,
                   flavor=flavor)


def create_commit_batch_verifier(validator_set, device="cuda",
                                 pubkey_cache=None,
                                 flavor=None) -> BatchVerifier:
    """Batch verifier for a validator set whose keys share one type."""
    types = {
        getattr(v.pub_key, "type", None)
        for v in getattr(validator_set, "validators", [])
    }
    backend = _BATCH_BACKENDS.get(next(iter(types))) if len(types) == 1 else None
    if backend is None:
        raise ValueError(
            f"batch verification unsupported for key types {sorted(types)!r}"
        )
    return backend(device=device, pubkey_cache=pubkey_cache,
                   flavor=flavor)
