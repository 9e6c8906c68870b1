"""Validator and ValidatorSet with proposer-priority rotation.

Reference: types/validator.go, types/validator_set.go:
* validators ordered by voting power desc, ties by address asc
  (ValidatorsByVotingPower, validator_set.go:752-767);
* IncrementProposerPriority: rescale to a 2*total window, shift by avg,
  then `times` rounds of (everyone += power; max -= total)
  (validator_set.go:116-178);
* set hash = merkle root of SimpleValidator proto encodings
  (validator.go:117-133);
* updates: changed and added validators merged, an added one starting at
  -1.125 x the new total's priority (validator_set.go:477-495).

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

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator has nil pubkey")
        if self.voting_power < 0:
            raise ValueError("negative voting power")
        if len(self.address) != 20:
            raise ValueError("address must be 20 bytes")

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
        self._reindex()
        if self.validators:
            self.increment_proposer_priority(1)

    def _reindex(self) -> None:
        """Rebuild the address -> index map after ``validators`` changed
        (every path that sets the list calls this)."""
        self._index = {v.address: i for i, v in enumerate(self.validators)}

    def __len__(self) -> int:
        return len(self.validators)

    # --- queries -------------------------------------------------------------

    def is_nil_or_empty(self) -> bool:
        return not self.validators

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

    def has_address(self, address: bytes) -> bool:
        return self.get_by_address(address)[0] >= 0

    def copy(self) -> "ValidatorSet":
        cp = ValidatorSet.__new__(ValidatorSet)
        cp.validators = [v.copy() for v in self.validators]
        cp.proposer = None
        cp._total = self._total
        cp._reindex()
        if self.proposer is not None:
            idx, _ = cp.get_by_address(self.proposer.address)
            cp.proposer = (cp.validators[idx] if idx >= 0
                           else self.proposer.copy())
        return cp

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
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        cp = self.copy()
        cp.increment_proposer_priority(times)
        return cp

    def rescale_priorities(self, diff_max: int) -> None:
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
        mostest = self._find_proposer()
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def get_proposer(self) -> Validator:
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        return mostest

    # --- updates -------------------------------------------------------------

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply ABCI validator updates (power 0 removes a validator).

        As validator_set.go:477-650: changes deduplicated and sorted by
        address, removals must exist, the new total computed, an added
        validator starts at -(new_total + new_total >> 3); then merge,
        sort by power, rescale and centre the priorities.
        """
        if not changes:
            return
        by_addr: dict[bytes, Validator] = {}
        for c in sorted(changes, key=lambda v: v.address):
            if c.address in by_addr:
                raise ValueError(f"duplicate update for {c.address.hex()}")
            if c.voting_power < 0:
                raise ValueError("negative voting power in update")
            by_addr[c.address] = c

        removals = {a for a, c in by_addr.items() if c.voting_power == 0}
        for addr in removals:
            if not self.has_address(addr):
                raise ValueError(
                    f"cannot remove unknown validator {addr.hex()}"
                )

        new_total = 0
        for v in self.validators:
            upd = by_addr.get(v.address)
            new_total += v.voting_power if upd is None else upd.voting_power
        for addr, c in by_addr.items():
            if not self.has_address(addr):
                new_total += c.voting_power
        if new_total > MAX_TOTAL_VOTING_POWER:
            raise ValueError("updates exceed max total voting power")
        if new_total == 0:
            raise ValueError("updates would remove all validators")

        merged: dict[bytes, Validator] = {
            v.address: v for v in self.validators
        }
        for addr, c in by_addr.items():
            if addr in removals:
                merged.pop(addr, None)
                continue
            existing = merged.get(addr)
            nv = c.copy()
            if existing is None:
                nv.proposer_priority = -(new_total + (new_total >> 3))
            else:
                nv.proposer_priority = existing.proposer_priority
            merged[addr] = nv

        self.validators = sorted(merged.values(), key=_sort_key)
        self._total = None
        self._reindex()
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        self.proposer = None

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is not None:
            self.proposer.validate_basic()

    # --- commit verification (validator_set.go:660-678) ----------------------

    def verify_commit(self, chain_id, block_id, height, commit, *,
                      device="cuda"):
        from . import validation

        validation.verify_commit(chain_id, self, block_id, height, commit,
                                 device=device)

    def verify_commit_light(self, chain_id, block_id, height, commit, *,
                            device="cuda"):
        from . import validation

        validation.verify_commit_light(chain_id, self, block_id, height,
                                       commit, device=device)

    def verify_commit_light_trusting(self, chain_id, commit, trust_level, *,
                                     device="cuda"):
        from . import validation

        validation.verify_commit_light_trusting(chain_id, self, commit,
                                                trust_level, device=device)
