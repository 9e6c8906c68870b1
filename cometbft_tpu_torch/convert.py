"""Carry state across from the JAX package to this one.

The JAX package's "weights" are its device state: the expanded-pubkey
arena of ``cometbft_tpu.ops.verify.PubkeyTableCache`` (a
``(16, 4, 20, capacity + 1)`` int32 array, its ``(capacity + 1,)`` ok bits
and the pubkey -> slot map) and the validator sets it verifies against.
Both arrive here as plain numpy arrays, bytes and ints, so this module
imports nothing of the JAX package. From the JAX side::

    arena, arena_ok = np.asarray(cache._arena), np.asarray(cache._arena_ok)
    slots = dict(cache._slots)
    pairs = [(v.pub_key.data, v.voting_power) for v in vals.validators]
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.keys import Ed25519PubKey
from .ops.verify import PubkeyTableCache
from .types.validator_set import Validator, ValidatorSet


def pubkey_cache_from_arrays(arena: np.ndarray, arena_ok: np.ndarray,
                             slots: dict[bytes, int],
                             device="cuda") -> PubkeyTableCache:
    """A PubkeyTableCache on ``device`` holding the given arena."""
    arena = np.asarray(arena)
    if arena.ndim != 4:
        raise ValueError(f"arena must be (16, 4, 20, S), got {arena.shape}")
    cache = PubkeyTableCache(device=device, capacity=arena.shape[-1] - 1)
    cache.load(
        {bytes(k): int(v) for k, v in slots.items()},
        torch.from_numpy(np.array(arena, np.int32)),
        torch.from_numpy(np.array(arena_ok, bool)),
    )
    return cache


def validator_set_from_pairs(pairs) -> ValidatorSet:
    """A ValidatorSet from (ed25519 pubkey bytes, voting power) pairs."""
    return ValidatorSet(
        [Validator(Ed25519PubKey(bytes(pk)), int(power)) for pk, power in pairs]
    )
