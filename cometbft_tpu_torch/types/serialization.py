"""Storage and wire codec of the data model: one shared ``Codec`` with
every persistable type registered (what proto/tendermint marshaling is to
store/store.go and state/store.go).

The codec tags a dataclass by its class name and writes its fields in
order, so the bytes of a block, a part or a commit are those the JAX
package writes for the same values: the part set built over
``dumps(block)``, and with it every BlockID, depends on that.

``ValidatorSet`` restores exactly (validator order, proposer, priorities):
its constructor rotates priorities, so decode bypasses it, and rebuilds
the address index that ``get_by_address`` reads.
"""

from __future__ import annotations

from ..crypto import keys
from ..crypto.merkle import Proof
from ..libs.jsoncodec import Codec
from . import evidence as ev
from .block import (
    Block,
    BlockID,
    BlockMeta,
    Commit,
    CommitSig,
    Data,
    ExtendedCommit,
    ExtendedCommitSig,
    Header,
    PartSetHeader,
    Version,
)
from .params import (
    ABCIParams,
    BlockParams,
    ConsensusParams,
    EvidenceParams,
    ValidatorParams,
    VersionParams,
)
from .light_block import LightBlock, SignedHeader
from .part_set import Part
from .validator_set import Validator, ValidatorSet
from .vote import Proposal, Vote

codec = Codec()

codec.register(
    Proof,
    PartSetHeader,
    BlockID,
    Version,
    Header,
    CommitSig,
    Commit,
    Data,
    Block,
    BlockMeta,
    ExtendedCommitSig,
    ExtendedCommit,
    Part,
    Vote,
    Proposal,
    Validator,
    BlockParams,
    EvidenceParams,
    ValidatorParams,
    VersionParams,
    ABCIParams,
    ConsensusParams,
    ev.DuplicateVoteEvidence,
    ev.LightClientAttackEvidence,
    SignedHeader,
    LightBlock,
)

from ..abci.types import Event, EventAttribute, ExecTxResult  # noqa: E402

codec.register(Event, EventAttribute, ExecTxResult)

codec.register_adapter(
    keys.Ed25519PubKey,
    "ed25519.pub",
    lambda pk: pk.bytes(),
    lambda raw: keys.Ed25519PubKey(raw),
)

# Every supported validator key type must round-trip through the codec:
# validator sets carrying them appear in consensus WAL messages, state
# snapshots, genesis docs, and light blocks (a mixed ed25519+sr25519 set
# is a first-class consensus citizen here — crypto/batch.MixedBatchVerifier).
from ..crypto.secp256k1 import Secp256k1PubKey  # noqa: E402
from ..crypto.sr25519 import Sr25519PubKey  # noqa: E402

codec.register_adapter(
    Sr25519PubKey,
    "sr25519.pub",
    lambda pk: pk.bytes(),
    lambda raw: Sr25519PubKey(raw),
)
codec.register_adapter(
    Secp256k1PubKey,
    "secp256k1.pub",
    lambda pk: pk.bytes(),
    lambda raw: Secp256k1PubKey(raw),
)


def _valset_enc(vs: ValidatorSet) -> dict:
    return {
        "validators": list(vs.validators),
        "proposer_address": vs.proposer.address if vs.proposer else b"",
    }


def _valset_dec(payload: dict) -> ValidatorSet:
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = list(payload["validators"])
    vs._total = None
    vs.proposer = None
    vs._reindex()
    addr = payload["proposer_address"]
    if addr:
        for v in vs.validators:
            if v.address == addr:
                vs.proposer = v
                break
    return vs


codec.register_adapter(ValidatorSet, "valset", _valset_enc, _valset_dec)

dumps = codec.dumps
loads = codec.loads
