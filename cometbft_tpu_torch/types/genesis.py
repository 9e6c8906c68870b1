"""Genesis document (reference: types/genesis.go)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field as dc_field

from ..crypto import keys, tmhash
from .params import ConsensusParams
from .validator_set import Validator

MAX_CHAIN_ID_LEN = 50


@dataclass(slots=True)
class GenesisValidator:
    pub_key: object
    power: int
    name: str = ""
    address: bytes = b""

    def __post_init__(self) -> None:
        if not self.address:
            self.address = bytes(self.pub_key.address())


@dataclass(slots=True)
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = dc_field(
        default_factory=ConsensusParams
    )
    validators: list[GenesisValidator] = dc_field(default_factory=list)
    app_hash: bytes = b""
    app_state: dict = dc_field(default_factory=dict)

    def validate_and_complete(self) -> None:
        """types/genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("chain_id too long")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        # The validator-set hash proto-encodes every key through the
        # tendermint.crypto.PublicKey oneof, which carries ONLY ed25519
        # and secp256k1 (keys.proto; the reference's PubKeyToProto
        # errors identically, crypto/encoding/codec.go:20-38). Reject
        # here with a clear message instead of crashing the consensus
        # FSM at enter-new-round.
        from .validator_set import pubkey_proto_encode

        for v in self.validators:
            if v.power == 0:
                raise ValueError("genesis validator cannot have power 0")
            try:
                pubkey_proto_encode(v.pub_key)
            except ValueError as e:
                raise ValueError(
                    f"genesis validator key not wire-encodable: {e} "
                    "(tendermint.crypto.PublicKey supports ed25519 and "
                    "secp256k1 only)"
                ) from e
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    def validator_set(self):
        from .validator_set import ValidatorSet

        return ValidatorSet(
            [
                Validator(pub_key=v.pub_key, voting_power=v.power)
                for v in self.validators
            ]
        )

    # --- JSON persistence ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "genesis_time_ns": self.genesis_time_ns,
                "chain_id": self.chain_id,
                "initial_height": self.initial_height,
                "app_hash": self.app_hash.hex(),
                "app_state": self.app_state,
                "validators": [
                    {
                        "pub_key": {
                            "type": v.pub_key.type,
                            "value": v.pub_key.bytes().hex(),
                        },
                        "power": v.power,
                        "name": v.name,
                    }
                    for v in self.validators
                ],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        d = json.loads(data)
        validators = [
            GenesisValidator(
                pub_key=keys.pubkey_from_type_and_bytes(
                    gv["pub_key"]["type"], bytes.fromhex(gv["pub_key"]["value"])
                ),
                power=int(gv["power"]),
                name=gv.get("name", ""),
            )
            for gv in d.get("validators", [])
        ]
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time_ns=int(d.get("genesis_time_ns", 0)),
            initial_height=int(d.get("initial_height", 1)),
            validators=validators,
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state", {}),
        )
        doc.validate_and_complete()
        return doc

    def hash(self) -> bytes:
        return tmhash.sum(self.to_json().encode())
