"""State persistence (reference: state/store.go:51-708).

Saves the ``State`` snapshot, per-height validator sets (full set when it
changed, else a pointer to the height it last changed — the reference's
checkpoint scheme, store.go:342), per-height consensus params, and
FinalizeBlock responses (for replay/handshake and the RPC
``block_results`` endpoint). All records go through the shared tagged-JSON
codec.
"""

from __future__ import annotations

import json

from ..libs import db as dbm
from ..libs import fail as libfail
from ..types import serialization as ser
from ..types.validator_set import ValidatorSet
from .state import State


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + b"%020d" % height


_STATE_KEY = b"stateKey"


class Store:
    def __init__(self, db: dbm.DB):
        self.db = db

    # -- state snapshot ----------------------------------------------------

    def save(self, state: State) -> None:
        """Persist state + the validator/params records for the heights the
        snapshot implies (store.go:182 save)."""
        libfail.delay_point("store-write")  # slow-disk injection seam
        batch = self.db.new_batch()
        next_height = state.last_block_height + 1
        if next_height == state.initial_height:
            # Genesis: validators(H) and validators(H+1) both known.
            self._save_validators(
                batch, next_height, state.validators,
                state.last_height_validators_changed,
            )
        self._save_validators(
            batch, next_height + 1, state.next_validators,
            state.last_height_validators_changed,
        )
        self._save_params(
            batch, next_height, state.consensus_params,
            state.last_height_consensus_params_changed,
        )
        batch.set(_STATE_KEY, self._encode_state(state))
        batch.write_sync()

    def load(self) -> State | None:
        raw = self.db.get(_STATE_KEY)
        return self._decode_state(raw) if raw else None

    def bootstrap(self, state: State) -> None:
        """Seed the store from an out-of-band state (statesync)."""
        batch = self.db.new_batch()
        height = state.last_block_height + 1
        if state.last_validators is not None and height > state.initial_height:
            self._save_validators(
                batch, height - 1, state.last_validators,
                state.last_height_validators_changed,
            )
        self._save_validators(
            batch, height, state.validators,
            state.last_height_validators_changed,
        )
        self._save_validators(
            batch, height + 1, state.next_validators,
            state.last_height_validators_changed,
        )
        self._save_params(
            batch, height, state.consensus_params,
            state.last_height_consensus_params_changed,
        )
        batch.set(_STATE_KEY, self._encode_state(state))
        batch.write_sync()

    @staticmethod
    def _encode_state(state: State) -> bytes:
        fields = {
            "chain_id": state.chain_id,
            "initial_height": state.initial_height,
            "last_block_height": state.last_block_height,
            "last_block_id": ser.codec.encode(state.last_block_id),
            "last_block_time_ns": state.last_block_time_ns,
            "next_validators": ser.codec.encode(state.next_validators),
            "validators": ser.codec.encode(state.validators),
            "last_validators": ser.codec.encode(state.last_validators),
            "last_height_validators_changed": state.last_height_validators_changed,
            "consensus_params": ser.codec.encode(state.consensus_params),
            "last_height_consensus_params_changed": state.last_height_consensus_params_changed,
            "last_results_hash": state.last_results_hash.hex(),
            "app_hash": state.app_hash.hex(),
            "app_version": state.app_version,
        }
        return json.dumps(fields, separators=(",", ":")).encode()

    @staticmethod
    def _decode_state(raw: bytes) -> State:
        d = json.loads(raw)
        return State(
            chain_id=d["chain_id"],
            initial_height=d["initial_height"],
            last_block_height=d["last_block_height"],
            last_block_id=ser.codec.decode(d["last_block_id"]),
            last_block_time_ns=d["last_block_time_ns"],
            next_validators=ser.codec.decode(d["next_validators"]),
            validators=ser.codec.decode(d["validators"]),
            last_validators=ser.codec.decode(d["last_validators"]),
            last_height_validators_changed=d["last_height_validators_changed"],
            consensus_params=ser.codec.decode(d["consensus_params"]),
            last_height_consensus_params_changed=d[
                "last_height_consensus_params_changed"
            ],
            last_results_hash=bytes.fromhex(d["last_results_hash"]),
            app_hash=bytes.fromhex(d["app_hash"]),
            app_version=d["app_version"],
        )

    # -- validator sets ----------------------------------------------------

    def _save_validators(
        self, batch, height: int, vals: ValidatorSet, last_changed: int
    ) -> None:
        if vals is None:
            return
        if last_changed < height and self.db.get(_h(b"vals:", last_changed)):
            record = {"ref": last_changed}
        else:
            record = {"set": ser.codec.encode(vals)}
        batch.set(_h(b"vals:", height), json.dumps(record).encode())

    def save_validator_set(
        self, height: int, vals: ValidatorSet, last_changed: int
    ) -> None:
        batch = self.db.new_batch()
        self._save_validators(batch, height, vals, last_changed)
        batch.write()

    def load_validators(self, height: int) -> ValidatorSet | None:
        raw = self.db.get(_h(b"vals:", height))
        if raw is None:
            return None
        record = json.loads(raw)
        if "ref" in record:
            raw = self.db.get(_h(b"vals:", record["ref"]))
            if raw is None:
                return None
            record = json.loads(raw)
            if "set" not in record:
                return None
        return ser.codec.decode(record["set"])

    # -- consensus params --------------------------------------------------

    def _save_params(self, batch, height, params, last_changed) -> None:
        if last_changed < height and self.db.get(_h(b"params:", last_changed)):
            record = {"ref": last_changed}
        else:
            record = {"params": ser.codec.encode(params)}
        batch.set(_h(b"params:", height), json.dumps(record).encode())

    def load_consensus_params(self, height: int):
        raw = self.db.get(_h(b"params:", height))
        if raw is None:
            return None
        record = json.loads(raw)
        if "ref" in record:
            raw = self.db.get(_h(b"params:", record["ref"]))
            if raw is None:
                return None
            record = json.loads(raw)
        return ser.codec.decode(record["params"])

    # -- ABCI responses ----------------------------------------------------

    def save_finalize_block_response(self, height: int, response) -> None:
        from ..abci import codec as abci_codec

        self.db.set(
            _h(b"abciResp:", height),
            json.dumps(abci_codec._to_jsonable(response)).encode(),
        )

    def load_finalize_block_response(self, height: int):
        from ..abci import codec as abci_codec

        raw = self.db.get(_h(b"abciResp:", height))
        if raw is None:
            return None
        return abci_codec._from_jsonable(json.loads(raw))

    def load_last_finalize_block_response(self, height: int):
        """Response for the LAST height, used by handshake replay."""
        return self.load_finalize_block_response(height)

    # -- pruning -----------------------------------------------------------

    def prune_states(self, retain_height: int) -> None:
        """Drop validator/params/response records below retain_height,
        keeping anything still referenced by pointer records."""
        for prefix in (b"vals:", b"params:", b"abciResp:"):
            keep_refs = set()
            if prefix in (b"vals:", b"params:"):
                raw = self.db.get(_h(prefix, retain_height))
                if raw is not None:
                    record = json.loads(raw)
                    if "ref" in record:
                        keep_refs.add(record["ref"])
            batch = self.db.new_batch()
            for key, _ in self.db.iterator(
                _h(prefix, 0), _h(prefix, retain_height)
            ):
                height = int(key[len(prefix):])
                if height not in keep_refs:
                    batch.delete(key)
            batch.write()
