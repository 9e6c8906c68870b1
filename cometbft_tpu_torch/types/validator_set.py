"""Validator and ValidatorSet with proposer-priority rotation.

Reference: types/validator.go, types/validator_set.go:
* validators ordered by voting power desc, ties by address asc
  (ValidatorsByVotingPower, validator_set.go:752-767);
* IncrementProposerPriority: rescale to a 2*total window, shift by avg,
  then `times` rounds of (everyone += power; max -= total)
  (validator_set.go:116-178);
* set hash = merkle root of SimpleValidator proto encodings
  (validator.go:117-133).

Clipping arithmetic (safeAddClip/safeSubClip) saturates at int64 bounds.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from . import proto

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    return max(INT64_MIN, min(INT64_MAX, v))


def pubkey_proto_encode(pub_key) -> bytes:
    """tendermint.crypto.PublicKey oneof body (keys.proto: ed25519=1,
    secp256k1=2). The proto has no sr25519 field: such a key raises, as it
    does in the reference, so a set holding one has no hash."""
    if pub_key.type == "ed25519":
        return proto.field_bytes(1, pub_key.bytes())
    if pub_key.type == "secp256k1":
        return proto.field_bytes(2, pub_key.bytes())
    raise ValueError(f"unsupported key type {pub_key.type}")


@dataclass(slots=True)
class Validator:
    pub_key: object
    voting_power: int
    proposer_priority: int = 0
    address: bytes = b""

    def __post_init__(self) -> None:
        if not self.address:
            self.address = bytes(self.pub_key.address())

    def copy(self) -> "Validator":
        return Validator(
            pub_key=self.pub_key,
            voting_power=self.voting_power,
            proposer_priority=self.proposer_priority,
            address=self.address,
        )

    def bytes(self) -> bytes:
        """SimpleValidator proto encoding (validator.go:117-133)."""
        return proto.field_message(
            1, pubkey_proto_encode(self.pub_key)
        ) + proto.field_varint(2, self.voting_power)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")


def _sort_key(v: Validator):
    # power desc, then address asc.
    return (-v.voting_power, v.address)


class ValidatorSet:
    def __init__(self, validators: list[Validator]):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in validators), key=_sort_key
        )
        self.proposer: Validator | None = None
        self._total: int | None = None
        self._index = {v.address: i for i, v in enumerate(self.validators)}
        if self.validators:
            self.increment_proposer_priority(1)

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total is None:
            total = sum(v.voting_power for v in self.validators)
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"total voting power {total} exceeds max "
                    f"{MAX_TOTAL_VOTING_POWER}"
                )
            self._total = total
        return self._total

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        i = self._index.get(bytes(address))
        if i is None:
            return -1, None
        return i, self.validators[i]

    def get_by_index(self, index: int) -> Validator | None:
        if 0 <= index < len(self.validators):
            return self.validators[index]
        return None

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [v.bytes() for v in self.validators]
        )

    # --- proposer rotation ---------------------------------------------------

    def increment_proposer_priority(self, times: int) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = abs(max(prios) - min(prios))
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                # Go int64 division truncates toward zero.
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _shift_by_avg_proposer_priority(self) -> None:
        n = len(self.validators)
        total = sum(v.proposer_priority for v in self.validators)
        # Go big.Int Div floors (Euclidean for positive divisor).
        avg = total // n
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(
                v.proposer_priority + v.voting_power
            )
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def get_proposer(self) -> Validator:
        if self.proposer is None:
            mostest = self.validators[0]
            for v in self.validators[1:]:
                mostest = mostest.compare_proposer_priority(v)
            self.proposer = mostest
        return self.proposer
