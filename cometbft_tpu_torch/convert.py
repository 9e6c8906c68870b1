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

A light-client chain (the reference's ``LightBlock`` objects: headers,
commits, validator sets) is carried across by reading its fields:
:func:`light_block_from` takes any object with the reference's attribute
names and builds this package's types from its bytes and ints. Blocks and
part sets come across the same way (:func:`block_from`,
:func:`part_set_from`), and so do votes and vote sets (:func:`vote_from`,
:func:`vote_set_from`). Keys of every registered type (ed25519, sr25519,
secp256k1) come across by their ``type`` and bytes (:func:`pubkey_from`),
so mixed validator sets do too (:func:`validator_set_from`).

A chain's state comes across the same way: its genesis
(:func:`genesis_from`), the replicated ``State`` with its three validator
sets exactly as they stand, priorities and proposer included
(:func:`state_from`), and the records the stores keep: a block's
``BlockMeta`` (:func:`block_meta_from`) and an ABCI ``FinalizeBlock``
response (:func:`abci_response_from`). Each equals what ``ser.loads`` of
this package makes of ``ser.dumps`` of the JAX package's object (the
codec tags by class name and both packages' classes have the same
fields): the tests hold the converters to that round trip.

A consensus run comes across the same way: a proposal
(:func:`proposal_from`), each message the consensus loop consumes and its
WAL records (:func:`message_from`: ``ProposalMessage``,
``BlockPartMessage``, ``VoteMessage``, ``MsgInfo``, ``TimeoutInfo``,
``EndHeightMessage``) and the consensus and mempool sections of a node's
config (:func:`config_from`). A WAL file needs no converter: its frames
carry the codec's tagged JSON, which this package's WAL decodes as it is.

The RLC batch equation (ops/rlc.py and its kernel X5) keeps no weights
and no state between calls: its inputs are a batch's bytes and fresh
random scalars, so nothing of it is carried across. Its plans, encodings
and launch arrays are plain numpy arrays in both packages, and the tests
feed the same ones to each.
"""

from __future__ import annotations

import numpy as np
import torch

import json

from . import config as node_config
from .abci import types as abci
from .consensus import messages as cmsg
from .consensus import wal as cwal
from .crypto import merkle
from .crypto.keys import Ed25519PubKey, pubkey_from_type_and_bytes
from .ops.verify import PubkeyTableCache
from .state.state import State
from .types import block, evidence, params
from .types.genesis import GenesisDoc, GenesisValidator
from .types.light_block import LightBlock, SignedHeader
from .types.part_set import Part, PartSet
from .types.validator_set import Validator, ValidatorSet
from .types.vote import Proposal, Vote
from .types.vote_set import VoteSet, _BlockVotes


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


def pubkey_from(pk):
    """This package's public key of ``pk``'s type (its ``type`` and
    ``data``: ed25519, sr25519 or secp256k1); ValueError for another."""
    return pubkey_from_type_and_bytes(str(pk.type), bytes(pk.data))


def validator_set_from(vs) -> ValidatorSet:
    """A ValidatorSet with the keys and voting powers of ``vs``'s
    validators, of any registered key type (a mixed set included)."""
    return ValidatorSet([Validator(pubkey_from(v.pub_key), int(v.voting_power))
                         for v in vs.validators])


def _block_id(bid) -> block.BlockID:
    psh = bid.part_set_header
    return block.BlockID(
        bytes(bid.hash), block.PartSetHeader(int(psh.total), bytes(psh.hash))
    )


def header_from(h) -> block.Header:
    """This package's Header with the fields of ``h``."""
    return block.Header(
        version=block.Version(int(h.version.block), int(h.version.app)),
        chain_id=str(h.chain_id),
        height=int(h.height),
        time_ns=int(h.time_ns),
        last_block_id=_block_id(h.last_block_id),
        last_commit_hash=bytes(h.last_commit_hash),
        data_hash=bytes(h.data_hash),
        validators_hash=bytes(h.validators_hash),
        next_validators_hash=bytes(h.next_validators_hash),
        consensus_hash=bytes(h.consensus_hash),
        app_hash=bytes(h.app_hash),
        last_results_hash=bytes(h.last_results_hash),
        evidence_hash=bytes(h.evidence_hash),
        proposer_address=bytes(h.proposer_address),
    )


def commit_from(c) -> block.Commit:
    """This package's Commit with the fields of ``c``."""
    return block.Commit(
        height=int(c.height),
        round=int(c.round),
        block_id=_block_id(c.block_id),
        signatures=[
            block.CommitSig(int(cs.block_id_flag),
                            bytes(cs.validator_address),
                            int(cs.timestamp_ns), bytes(cs.signature))
            for cs in c.signatures
        ],
    )


def light_block_from(lb) -> LightBlock:
    """This package's LightBlock with the header, commit and validator set
    of ``lb``."""
    sh = lb.signed_header
    return LightBlock(
        signed_header=SignedHeader(header_from(sh.header),
                                   commit_from(sh.commit)),
        validator_set=validator_set_from(lb.validator_set),
    )


def light_chain_from(blocks: dict) -> dict[int, LightBlock]:
    """{height: LightBlock} carried across block by block."""
    return {int(h): light_block_from(lb) for h, lb in blocks.items()}


def data_from(d) -> block.Data:
    """This package's Data with the txs of ``d``."""
    return block.Data(txs=[bytes(tx) for tx in d.txs])


def evidence_from(ev):
    """This package's DuplicateVoteEvidence or LightClientAttackEvidence
    with the fields of ``ev``."""
    if type(ev).__name__ == "DuplicateVoteEvidence":
        return evidence.DuplicateVoteEvidence(
            vote_a=vote_from(ev.vote_a), vote_b=vote_from(ev.vote_b),
            total_voting_power=int(ev.total_voting_power),
            validator_power=int(ev.validator_power),
            timestamp_ns=int(ev.timestamp_ns))
    if type(ev).__name__ == "LightClientAttackEvidence":
        return evidence.LightClientAttackEvidence(
            conflicting_block=light_block_from(ev.conflicting_block),
            common_height=int(ev.common_height),
            byzantine_validators=[_validator_exact(v) for v in
                                  ev.byzantine_validators],
            total_voting_power=int(ev.total_voting_power),
            timestamp_ns=int(ev.timestamp_ns))
    raise ValueError(f"unknown evidence type {type(ev).__name__}")


def block_from(b) -> block.Block:
    """This package's Block with the header, txs, evidence and last commit
    of ``b``."""
    return block.Block(
        header=header_from(b.header),
        data=data_from(b.data),
        evidence=[evidence_from(ev) for ev in b.evidence],
        last_commit=(commit_from(b.last_commit)
                     if b.last_commit is not None else None),
    )


def part_from(p) -> Part:
    """This package's Part with the index, bytes and proof of ``p``."""
    pr = p.proof
    return Part(
        index=int(p.index),
        bytes_=bytes(p.bytes_),
        proof=merkle.Proof(int(pr.total), int(pr.index), bytes(pr.leaf_hash),
                           [bytes(a) for a in pr.aunts]),
    )


def part_set_from(ps) -> PartSet:
    """This package's PartSet with the header of ``ps``; each part it
    holds is carried across through ``add_part``, so a part whose proof
    does not verify raises PartSetError."""
    h = ps.header
    out = PartSet(block.PartSetHeader(int(h.total), bytes(h.hash)))
    for p in ps.parts:
        if p is not None:
            out.add_part(part_from(p))
    return out


def vote_from(v) -> Vote:
    """This package's Vote with the fields of ``v``."""
    return Vote(
        msg_type=int(v.msg_type),
        height=int(v.height),
        round=int(v.round),
        block_id=_block_id(v.block_id),
        timestamp_ns=int(v.timestamp_ns),
        validator_address=bytes(v.validator_address),
        validator_index=int(v.validator_index),
        signature=bytes(v.signature),
        extension=bytes(v.extension),
        extension_signature=bytes(v.extension_signature),
    )


def vote_set_from(vs, device="cuda") -> VoteSet:
    """This package's VoteSet in the state of ``vs``: its validator set,
    its admitted votes, per-block tallies, peer claims and latched
    majority, carried as they are (nothing is verified again). ``device``
    is where the new set's batches verify."""
    vals = validator_set_from(vs.val_set)
    out = VoteSet(str(vs.chain_id), int(vs.height), int(vs.round),
                  int(vs.signed_msg_type), vals,
                  extensions_enabled=bool(vs.extensions_enabled),
                  device=device)
    votes = {}  # one port Vote per reference vote object

    def carried(v):
        if v is None:
            return None
        if id(v) not in votes:
            votes[id(v)] = vote_from(v)
        return votes[id(v)]

    out.votes = [carried(v) for v in vs.votes]
    for i, v in enumerate(out.votes):
        if v is not None:
            out.votes_bit_array.set_index(i, True)
    out.sum = int(vs.sum)
    out.maj23 = _block_id(vs.maj23) if vs.maj23 is not None else None
    for key, bv in vs.votes_by_block.items():
        nbv = _BlockVotes(bool(bv.peer_maj23), len(vals))
        nbv.votes = [carried(v) for v in bv.votes]
        for i, v in enumerate(nbv.votes):
            if v is not None:
                nbv.bit_array.set_index(i, True)
        nbv.sum = int(bv.sum)
        out.votes_by_block[bytes(key)] = nbv
    out.peer_maj23s = {str(p): _block_id(b)
                       for p, b in vs.peer_maj23s.items()}
    return out


def _validator_exact(v) -> Validator:
    return Validator(pubkey_from(v.pub_key), int(v.voting_power),
                     int(v.proposer_priority), bytes(v.address))


def validator_set_exact(vs) -> ValidatorSet | None:
    """This package's ValidatorSet in the state of ``vs``: the same
    validators in the same order, with their proposer priorities and the
    same proposer (no rotation, unlike :func:`validator_set_from`)."""
    if vs is None:
        return None
    out = ValidatorSet.__new__(ValidatorSet)
    out.validators = [_validator_exact(v) for v in vs.validators]
    out._total = None
    out._reindex()
    out.proposer = None
    if vs.proposer is not None:
        _, out.proposer = out.get_by_address(bytes(vs.proposer.address))
    return out


def params_from(p) -> params.ConsensusParams:
    """This package's ConsensusParams with the sections of ``p``."""
    return params.ConsensusParams(
        block=params.BlockParams(int(p.block.max_bytes),
                                 int(p.block.max_gas)),
        evidence=params.EvidenceParams(
            int(p.evidence.max_age_num_blocks),
            int(p.evidence.max_age_duration_ns), int(p.evidence.max_bytes)),
        validator=params.ValidatorParams(
            tuple(str(t) for t in p.validator.pub_key_types)),
        version=params.VersionParams(int(p.version.app)),
        abci=params.ABCIParams(int(p.abci.vote_extensions_enable_height)),
    )


def genesis_from(g) -> GenesisDoc:
    """This package's GenesisDoc with the fields of ``g`` (its app state
    through JSON, as the genesis file holds it)."""
    return GenesisDoc(
        chain_id=str(g.chain_id),
        genesis_time_ns=int(g.genesis_time_ns),
        initial_height=int(g.initial_height),
        consensus_params=params_from(g.consensus_params),
        validators=[GenesisValidator(pubkey_from(v.pub_key), int(v.power),
                                     str(v.name), bytes(v.address))
                    for v in g.validators],
        app_hash=bytes(g.app_hash),
        app_state=json.loads(json.dumps(g.app_state)),
    )


def state_from(s) -> State:
    """This package's State with the fields of ``s``, its validator sets
    carried exactly (:func:`validator_set_exact`)."""
    return State(
        chain_id=str(s.chain_id),
        initial_height=int(s.initial_height),
        last_block_height=int(s.last_block_height),
        last_block_id=_block_id(s.last_block_id),
        last_block_time_ns=int(s.last_block_time_ns),
        next_validators=validator_set_exact(s.next_validators),
        validators=validator_set_exact(s.validators),
        last_validators=validator_set_exact(s.last_validators),
        last_height_validators_changed=int(
            s.last_height_validators_changed),
        consensus_params=params_from(s.consensus_params),
        last_height_consensus_params_changed=int(
            s.last_height_consensus_params_changed),
        last_results_hash=bytes(s.last_results_hash),
        app_hash=bytes(s.app_hash),
        app_version=int(s.app_version),
    )


def block_meta_from(m) -> block.BlockMeta:
    """This package's BlockMeta with the fields of ``m``."""
    return block.BlockMeta(block_id=_block_id(m.block_id),
                           block_size=int(m.block_size),
                           header=header_from(m.header),
                           num_txs=int(m.num_txs))


def _event_from(e) -> abci.Event:
    return abci.Event(str(e.type), [
        abci.EventAttribute(str(a.key), str(a.value), bool(a.index))
        for a in e.attributes])


def abci_response_from(r) -> abci.ResponseFinalizeBlock:
    """This package's ResponseFinalizeBlock with the fields of ``r``: its
    events, tx results, validator updates, parameter updates and app
    hash."""
    return abci.ResponseFinalizeBlock(
        events=[_event_from(e) for e in r.events],
        tx_results=[abci.ExecTxResult(
            code=int(t.code), data=bytes(t.data), log=str(t.log),
            info=str(t.info), gas_wanted=int(t.gas_wanted),
            gas_used=int(t.gas_used),
            events=[_event_from(e) for e in t.events],
            codespace=str(t.codespace)) for t in r.tx_results],
        validator_updates=[abci.ValidatorUpdate(
            str(u.pub_key_type), bytes(u.pub_key_bytes), int(u.power))
            for u in r.validator_updates],
        consensus_param_updates=(
            None if r.consensus_param_updates is None
            else params_from(r.consensus_param_updates)),
        app_hash=bytes(r.app_hash),
    )


def proposal_from(p) -> Proposal:
    """This package's Proposal with the fields of ``p``."""
    return Proposal(
        height=int(p.height), round=int(p.round),
        pol_round=int(p.pol_round), block_id=_block_id(p.block_id),
        timestamp_ns=int(p.timestamp_ns), signature=bytes(p.signature),
    )


def message_from(m):
    """This package's consensus message or WAL record with the fields of
    ``m``, by its class name: ProposalMessage, BlockPartMessage,
    VoteMessage, MsgInfo (its message converted the same way),
    TimeoutInfo and EndHeightMessage."""
    kind = type(m).__name__
    if kind == "ProposalMessage":
        return cmsg.ProposalMessage(proposal_from(m.proposal))
    if kind == "BlockPartMessage":
        return cmsg.BlockPartMessage(int(m.height), int(m.round),
                                     part_from(m.part))
    if kind == "VoteMessage":
        return cmsg.VoteMessage(vote_from(m.vote))
    if kind == "MsgInfo":
        return cwal.MsgInfo(message_from(m.msg), str(m.peer_id))
    if kind == "TimeoutInfo":
        return cwal.TimeoutInfo(float(m.duration_s), int(m.height),
                                int(m.round), int(m.step))
    if kind == "EndHeightMessage":
        return cwal.EndHeightMessage(int(m.height))
    raise TypeError(f"no converter for a {kind}")


def config_from(c) -> node_config.Config:
    """This package's Config (its defaults) with the consensus and
    mempool sections of ``c``, the two the port reads."""
    out = node_config.default_config()
    out.consensus = node_config.ConsensusConfig(**{
        f: getattr(c.consensus, f)
        for f in node_config.ConsensusConfig.__dataclass_fields__})
    out.mempool = node_config.MempoolConfig(**{
        f: getattr(c.mempool, f)
        for f in node_config.MempoolConfig.__dataclass_fields__})
    return out
