"""The port's block-execution and storage layer (state/, store/,
abci kvstore and proxy, libs/db, types/serialization, genesis, params,
evidence, the rest of the validator set) against the JAX package's.

A seeded 4-validator chain runs on both packages from the same genesis,
txs and ``time_ns``: heights 1-6 through BlockExecutor (create_proposal_
block -> PartSet.from_data(ser.dumps(block)) -> apply_block ->
BlockStore.save_block with a commit signed by the height's validators),
height 3 carrying a ``val:`` tx that adds a fifth validator (so blocks 5
and 6 are made by five), then a seventh block whose LastCommit has one
spoiled signature. Every height's codec bytes, block hash, part-set
header, FinalizeBlock response, State (each field, validator priorities
and proposer included), events and the sorted (key, value) contents of
the app, state and block stores' MemDBs must be equal, byte for byte.
Commits of 4-5 validators stay under both packages' verify cuts (the
host batch); one case pins the port's cut to 2 so that its plain K2 and
X1 run under validate_block, against the reference's host route.
"""

import dataclasses
import hashlib
import importlib

import pytest

from cometbft_tpu.types import serialization as rser
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.types import serialization as tser

# Both packages' consensus messages, WAL records and blocksync messages
# register with the codec on import (the port's consensus ones through
# convert): import both here, so the
# registries this file's codec cases are drawn from do not depend on what
# else the worker imported first.
importlib.import_module("cometbft_tpu.consensus.messages")
importlib.import_module("cometbft_tpu.consensus.wal")
importlib.import_module("cometbft_tpu_torch.consensus.messages")
importlib.import_module("cometbft_tpu_torch.consensus.wal")
importlib.import_module("cometbft_tpu.blocksync.messages")
importlib.import_module("cometbft_tpu_torch.blocksync.messages")

CHAIN = "exec-chain"
T0 = 1_760_000_000_000_000_000
N = 4
HEIGHTS = 6
UPDATE_HEIGHT = 3
TAMPERED = 2


def _seed(i: int) -> bytes:
    return hashlib.sha256(b"exec-validator" + bytes([i])).digest()


def _txs(height: int) -> list[bytes]:
    txs = [b"h%d-k%d=%s" % (height, i, hashlib.sha256(
        b"%d-%d" % (height, i)).hexdigest().encode()[: 5 + 7 * i])
           for i in range(6)]
    txs.append(b"bad-tx-no-equals")
    return txs


class _ListMempool:
    def __init__(self):
        self.txs = []

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs)

    def lock(self):
        pass

    def unlock(self):
        pass

    def update(self, height, txs, results, *a, **k):
        self.txs = [t for t in self.txs if t not in set(txs)]


class Chain:
    """One package's chain: genesis, app over proxy, MemDB stores, event
    bus, executor; ``heights`` holds what each height produced."""

    def __init__(self, pkg: str, **executor_kw):
        m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa
        self.m = m
        keys, types, abci = m("crypto.keys"), m("types"), m("abci.types")
        dbm, st, proxy = m("libs.db"), m("state"), m("proxy")
        self.privs = [keys.Ed25519PrivKey.from_seed(_seed(i))
                      for i in range(N + 1)]
        self.by_addr = {p.pub_key().address(): p for p in self.privs}
        self.genesis = types.GenesisDoc(
            chain_id=CHAIN, genesis_time_ns=T0, validators=[
                types.GenesisValidator(p.pub_key(), 10, f"v{i}")
                for i, p in enumerate(self.privs[:N])],
            app_state={"seed": 14})
        self.state = st.make_genesis_state(self.genesis)
        self.dbs = {n: dbm.MemDB() for n in ("app", "state", "blocks")}
        self.app = m("abci.kvstore").KVStoreApplication(self.dbs["app"])
        self.conns = proxy.AppConns(proxy.local_client_creator(self.app))
        self.conns.start()
        init = self.conns.consensus.init_chain(abci.RequestInitChain(
            time_ns=T0, chain_id=CHAIN, validators=[
                abci.ValidatorUpdate("ed25519", p.pub_key().bytes(), 10)
                for p in self.privs[:N]]))
        self.state.app_hash = init.app_hash
        self.store = st.Store(self.dbs["state"])
        self.store.save(self.state)
        self.block_store = m("store").BlockStore(self.dbs["blocks"])
        self.bus = m("types.event_bus").EventBus()
        self.bus.start()
        self.sub = self.bus.subscribe("all", m("libs.pubsub").Empty(),
                                      capacity=None)
        self.mempool = _ListMempool()
        self.exe = st.BlockExecutor(
            self.store, self.conns.consensus, mempool=self.mempool,
            block_store=self.block_store, event_bus=self.bus,
            **executor_kw)
        self.last_ext = None
        self.heights = {}
        self.blocks = {}

    def snapshot(self) -> dict:
        return {n: sorted(db.iterator()) for n, db in self.dbs.items()}

    def events(self) -> list:
        out = []
        while not self.sub.out.empty():
            msg = self.sub.out.get_nowait()
            out.append((type(msg.data).__name__, msg.events))
        return out

    def commit_for(self, height, bid, vals, tamper=None):
        blk = self.m("types.block")
        sigs = [blk.CommitSig(blk.BLOCK_ID_FLAG_COMMIT, v.address,
                              T0 + height * 10**9 + 500 + 7 * i)
                for i, v in enumerate(vals.validators)]
        c = blk.Commit(height, 0, bid, sigs)
        c.signatures = [blk.CommitSig(
            cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
            self.by_addr[cs.validator_address].sign(
                c.vote_sign_bytes(CHAIN, i))) for i, cs in enumerate(sigs)]
        if tamper is not None:
            cs = c.signatures[tamper]
            c.signatures[tamper] = dataclasses.replace(
                cs, signature=bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
        return c

    def extended(self, c):
        blk = self.m("types.block")
        return blk.ExtendedCommit(c.height, c.round, c.block_id,
                                  [blk.ExtendedCommitSig(cs)
                                   for cs in c.signatures])

    def propose(self, height):
        ser = self.m("types.serialization")
        self.mempool.txs = _txs(height)
        if height == UPDATE_HEIGHT:
            self.mempool.txs.append(
                b"val:" + self.privs[N].pub_key().bytes().hex().encode()
                + b"!10")
        proposer = self.state.validators.get_proposer().address
        b = self.exe.create_proposal_block(height, self.state, self.last_ext,
                                           proposer,
                                           time_ns=T0 + height * 10**9)
        data = ser.dumps(b)
        ps = self.m("types.part_set").PartSet.from_data(data)
        bid = self.m("types.block").BlockID(b.hash(), ps.header)
        return b, data, ps, bid, proposer

    def run(self, heights=HEIGHTS, last_tamper=None):
        for h in range(1, heights + 1):
            b, data, ps, bid, proposer = self.propose(h)
            accepted = self.exe.process_proposal(b, self.state)
            self.state = self.exe.apply_block(self.state, bid, b)
            tamper = last_tamper if h == heights else None
            c = self.commit_for(h, bid, self.state.last_validators, tamper)
            self.block_store.save_block(b, ps, c)
            self.last_ext = self.extended(c)
            self.blocks[h] = b
            self.heights[h] = dict(
                data=data, hash=b.hash(), psh=ps.header, proposer=proposer,
                accepted=accepted, state=self.state,
                resp=self.store.load_finalize_block_response(h),
                state_bytes=self.m("state").Store._encode_state(self.state),
                stores=self.snapshot(), events=self.events())
        return self

    def tampered_block(self):
        """The next block over a LastCommit with TAMPERED spoiled: (the
        error, whether anything changed)."""
        h = max(self.heights) + 1
        sigs = list(self.last_ext.extended_signatures)
        cs = sigs[TAMPERED].commit_sig
        sigs[TAMPERED] = dataclasses.replace(
            sigs[TAMPERED], commit_sig=dataclasses.replace(
                cs, signature=bytes([cs.signature[0] ^ 1])
                + cs.signature[1:]))
        self.last_ext = dataclasses.replace(self.last_ext,
                                            extended_signatures=sigs)
        b, _, _, bid, _ = self.propose(h)
        before = (self.snapshot(), self.m("state").Store._encode_state(
            self.state), self.app.app_hash, self.app.height)
        err = None
        try:
            self.exe.apply_block(self.state, bid, b)
        except self.m("state.validation").BlockValidationError as e:
            err = str(e)
        after = (self.snapshot(), self.m("state").Store._encode_state(
            self.state), self.app.app_hash, self.app.height)
        return err, before == after


@pytest.fixture(scope="module")
def chains():
    ref = Chain("cometbft_tpu").run()
    port = Chain("cometbft_tpu_torch", device="cpu").run()
    yield ref, port
    for c in (ref, port):
        c.bus.stop()
        c.conns.stop()


ASPECTS = ("codec_bytes", "block_hash", "part_set_header", "proposer",
           "finalize_response", "state_fields", "state_bytes",
           "store_contents", "events", "process_proposal")


def _valset(vs):
    if vs is None:
        return None
    return ([(v.address, v.pub_key.bytes(), v.voting_power,
              v.proposer_priority) for v in vs.validators],
            vs.proposer.address if vs.proposer else None)


def _state_fields(s):
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name.endswith("validators"):
            v = _valset(v)
        elif dataclasses.is_dataclass(v):
            v = rser.codec.encode(v) if type(v).__module__.startswith(
                "cometbft_tpu.") else tser.codec.encode(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("height", range(1, HEIGHTS + 1))
@pytest.mark.parametrize("aspect", ASPECTS)
def test_chain_equals_reference(chains, height, aspect):
    ref, port = (c.heights[height] for c in chains)
    if aspect == "codec_bytes":
        assert port["data"] == ref["data"]
    elif aspect == "block_hash":
        assert port["hash"] == ref["hash"] and len(port["hash"]) == 32
    elif aspect == "part_set_header":
        assert (port["psh"].total, port["psh"].hash) == (
            ref["psh"].total, ref["psh"].hash)
    elif aspect == "proposer":
        assert port["proposer"] == ref["proposer"]
    elif aspect == "finalize_response":
        from cometbft_tpu.abci import codec as rc
        from cometbft_tpu_torch.abci import codec as tc

        assert tc._to_jsonable(port["resp"]) == rc._to_jsonable(ref["resp"])
        assert len(port["resp"].tx_results) == 7 + (height == UPDATE_HEIGHT)
    elif aspect == "state_fields":
        assert _state_fields(port["state"]) == _state_fields(ref["state"])
    elif aspect == "state_bytes":
        assert port["state_bytes"] == ref["state_bytes"]
    elif aspect == "store_contents":
        assert port["stores"] == ref["stores"]
    elif aspect == "events":
        assert port["events"] == ref["events"]
        assert sum(1 for name, _ in port["events"]
                   if name == "EventDataTx") == 7 + (height == UPDATE_HEIGHT)
    else:
        # the kvstore rejects a proposal with a malformed tx (each height
        # carries one); apply_block still executes it, as the reference
        assert port["accepted"] is ref["accepted"] is False


def test_validator_update_and_proposers_follow_the_reference(chains):
    """The val: tx of height 3 adds the fifth key to next_validators at
    height 3, validators from height 5; its starting priority, the
    rotation and every proposer equal the reference's, clip for clip."""
    ref, port = chains
    sizes = [len(port.heights[h]["state"].validators)
             for h in range(1, HEIGHTS + 1)]
    assert sizes == [N, N, N, N + 1, N + 1, N + 1]
    assert [len(ref.heights[h]["state"].validators)
            for h in range(1, HEIGHTS + 1)] == sizes
    assert [port.heights[h]["proposer"] for h in port.heights] == [
        ref.heights[h]["proposer"] for h in ref.heights]
    for h in range(1, HEIGHTS + 1):
        for name in ("validators", "next_validators", "last_validators"):
            assert _valset(getattr(port.heights[h]["state"], name)) == \
                _valset(getattr(ref.heights[h]["state"], name))
    assert port.heights[UPDATE_HEIGHT]["state"].\
        last_height_validators_changed == UPDATE_HEIGHT + 2


def test_tampered_last_commit_is_refused_as_reference(chains):
    """The seventh block's LastCommit with one spoiled signature raises
    BlockValidationError in both, naming the same index, and leaves the
    state, the stores and the app as they were."""
    got = [c.tampered_block() for c in chains]
    assert got[1] == got[0]
    err, unchanged = got[1]
    assert f"wrong signature (#{TAMPERED})" in err and unchanged


def test_block_store_loads_as_reference(chains):
    ref, port = chains
    for h in range(1, HEIGHTS + 1):
        rb, tb = ref.block_store, port.block_store
        assert tb.load_block(h).hash() == rb.load_block(h).hash() == \
            ref.blocks[h].hash()
        assert tser.dumps(tb.load_block(h)) == rser.dumps(rb.load_block(h))
        assert tser.dumps(tb.load_block_meta(h)) == rser.dumps(
            rb.load_block_meta(h))
        assert tser.dumps(tb.load_block_part(h, 0)) == rser.dumps(
            rb.load_block_part(h, 0))
        assert tser.dumps(tb.load_block_by_hash(ref.blocks[h].hash())) == \
            rser.dumps(rb.load_block_by_hash(ref.blocks[h].hash()))
        if h < HEIGHTS:
            assert tser.dumps(tb.load_block_commit(h)) == rser.dumps(
                rb.load_block_commit(h))
    assert tser.dumps(port.block_store.load_seen_commit()) == rser.dumps(
        ref.block_store.load_seen_commit())
    assert (port.block_store.base(), port.block_store.height(),
            port.block_store.size()) == (1, HEIGHTS, HEIGHTS)


def test_state_store_loads_as_reference(chains):
    ref, port = chains
    for h in range(1, HEIGHTS + 2):
        assert _valset(port.store.load_validators(h)) == _valset(
            ref.store.load_validators(h))
        tp, rp = (c.store.load_consensus_params(h) for c in chains[::-1])
        assert (tp is None) == (rp is None)
        if tp is not None:
            assert tser.dumps(tp) == rser.dumps(rp)
    loaded = port.store.load()
    assert _state_fields(loaded) == _state_fields(ref.store.load())
    # the valset adapter rebuilds the address index
    v = loaded.validators.validators[-1]
    assert loaded.validators.get_by_address(v.address)[1] is v
    assert loaded.validators.has_address(v.address)


def _fresh_chain_pair(heights):
    ref = Chain("cometbft_tpu").run(heights)
    port = Chain("cometbft_tpu_torch", device="cpu").run(heights)
    return ref, port


@pytest.mark.parametrize("retain", [2, 4])
def test_pruning_equals_reference(retain):
    """BlockStore.prune_blocks and Store.prune_states leave the same
    records; delete_block of the tip keeps its LastCommit as the seen
    commit, as the reference does."""
    pair = _fresh_chain_pair(5)
    for c in pair:
        c.pruned = c.block_store.prune_blocks(retain)
        c.store.prune_states(retain)
        c.block_store.delete_block(5)
    ref, port = pair
    assert port.pruned == ref.pruned == retain - 1
    assert port.snapshot() == ref.snapshot()
    assert port.block_store.base() == retain
    with pytest.raises(ValueError, match="tip"):
        port.block_store.delete_block(1)
    with pytest.raises(ValueError, match="expected"):
        port.block_store.save_block(port.blocks[2], None, None)


def test_pinned_cut_runs_plain_k2_and_x1_as_the_reference_host_route(
        monkeypatch):
    """With crypto.batch's cut pinned to 2 the port's validate_block
    verifies each LastCommit on the device route: X1's plain version
    builds the four keys into a cold arena, K2's plain version verifies
    (launches counted at the wrappers). Verdicts and the tampered
    commit's error equal the reference's host route."""
    from cometbft_tpu_torch.crypto import batch as tbatch
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", 2)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    counts = {}
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else k["y_a"] if "y_a" in k
                     else a[0]).shape[-1]
            counts.setdefault(_name, []).append(lanes)
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)
    ref = Chain("cometbft_tpu").run(2)
    port = Chain("cometbft_tpu_torch", device="cpu").run(2)
    assert counts == {"build_pubkey_tables": [N],
                      "verify_kernel_cached": [N]}
    assert port.heights[2]["stores"] == ref.heights[2]["stores"]
    got = [c.tampered_block() for c in (ref, port)]
    assert got[1] == got[0] and got[1][1]
    assert f"wrong signature (#{TAMPERED})" in got[1][0]
    assert counts["verify_kernel_cached"] == [N, N]


def _samples(ref_chain):
    """One reference object of each type the codec registers, from the
    chain and built beside it."""
    from cometbft_tpu.blocksync import messages as rbs
    from cometbft_tpu.consensus import messages as rmsg, wal as rwal
    from cometbft_tpu.libs.bits import BitArray
    from cometbft_tpu.types import block as rb, evidence as rev, params
    from cometbft_tpu.types.light_block import LightBlock, SignedHeader
    from cometbft_tpu.types.vote import Proposal, Vote

    b = ref_chain.blocks[4]
    meta = ref_chain.block_store.load_block_meta(4)
    part = ref_chain.block_store.load_block_part(4, 0)
    commit = ref_chain.block_store.load_block_commit(4)
    state = ref_chain.heights[4]["state"]
    resp = ref_chain.heights[UPDATE_HEIGHT]["resp"]
    ext = ref_chain.last_ext
    vote = Vote(2, 4, 0, commit.block_id, T0, commit.signatures[0].
                validator_address, 0, commit.signatures[0].signature,
                b"ext", b"\x01" * 64)
    other = dataclasses.replace(vote, block_id=rb.BlockID(
        b"\x02" * 32, rb.PartSetHeader(1, b"\x03" * 32)))
    dve = rev.DuplicateVoteEvidence.from_conflicting_votes(
        vote, other, T0, state.validators)
    lb = LightBlock(SignedHeader(b.header, commit), state.validators)
    lca = rev.LightClientAttackEvidence(lb, 3, [state.validators.validators[
        1]], 40, T0 + 5)
    event = resp.tx_results[0].events[0]
    prop = Proposal(4, 1, -1, meta.block_id, T0, b"\x04" * 64)
    bits = BitArray.from_indices(7, [0, 3, 6])
    return {
        "Proof": part.proof, "PartSetHeader": meta.block_id.part_set_header,
        "BlockID": meta.block_id, "Version": b.header.version,
        "Header": b.header, "CommitSig": commit.signatures[1],
        "Commit": commit, "Data": b.data, "Block": b, "BlockMeta": meta,
        "ExtendedCommitSig": ext.extended_signatures[0],
        "ExtendedCommit": ext, "Part": part, "Vote": vote,
        "Proposal": prop,
        "Validator": state.validators.validators[0],
        "BlockParams": params.BlockParams(1000, 7),
        "EvidenceParams": params.EvidenceParams(5, 6, 7),
        "ValidatorParams": params.ValidatorParams(("ed25519", "sr25519")),
        "VersionParams": params.VersionParams(3),
        "ABCIParams": params.ABCIParams(9),
        "ConsensusParams": state.consensus_params,
        "DuplicateVoteEvidence": dve, "LightClientAttackEvidence": lca,
        "SignedHeader": lb.signed_header, "LightBlock": lb,
        "Event": event, "EventAttribute": event.attributes[0],
        "ExecTxResult": resp.tx_results[0],
        "valset": state.next_validators,
        "ProposalMessage": rmsg.ProposalMessage(prop),
        "BlockPartMessage": rmsg.BlockPartMessage(4, 0, part),
        "VoteMessage": rmsg.VoteMessage(vote),
        "NewRoundStepMessage": rmsg.NewRoundStepMessage(4, 1, 3, 2, 0),
        "NewValidBlockMessage": rmsg.NewValidBlockMessage(
            4, 1, meta.block_id.part_set_header, bits, True),
        "ProposalPOLMessage": rmsg.ProposalPOLMessage(4, 0, bits),
        "HasVoteMessage": rmsg.HasVoteMessage(4, 1, 2, 5),
        "VoteSetMaj23Message": rmsg.VoteSetMaj23Message(4, 1, 2,
                                                        meta.block_id),
        "VoteSetBitsMessage": rmsg.VoteSetBitsMessage(4, 1, 2,
                                                      meta.block_id, bits),
        "EndHeightMessage": rwal.EndHeightMessage(4),
        "MsgInfo": rwal.MsgInfo(rmsg.VoteMessage(vote), "peer"),
        "TimeoutInfo": rwal.TimeoutInfo(0.5, 4, 1, 3),
        "StatusRequestMessage": rbs.StatusRequestMessage(),
        "StatusResponseMessage": rbs.StatusResponseMessage(9, 2),
        "BlockRequestMessage": rbs.BlockRequestMessage(7),
        "BlockResponseMessage": rbs.BlockResponseMessage(b, ext),
        "NoBlockResponseMessage": rbs.NoBlockResponseMessage(11),
    }


@pytest.mark.parametrize("name", sorted(tser.codec._types) + ["valset"])
def test_codec_round_trip_of_each_registered_type(chains, name):
    """The reference's bytes of each registered type load into the port's
    type and dump back to the same bytes; the port's own object loads into
    the reference's equal to the original; the consensus messages and WAL
    records too, with the BitArray adapter. (The reference's registry may
    hold more: its statesync, pex and indexer modules register
    their messages when imported.)"""
    if name == "valset":
        assert set(tser.codec._adapters_by_tag) <= set(
            rser.codec._adapters_by_tag)
    else:
        assert rser.codec._types[name].__name__ == name
    obj = _samples(chains[0])[name]
    blob = rser.dumps(obj)
    ours = tser.loads(blob)
    assert type(ours).__module__.startswith("cometbft_tpu_torch.")
    assert tser.dumps(ours) == blob
    assert rser.dumps(rser.loads(tser.dumps(ours))) == blob
    if name == "valset":
        v = ours.validators[-1]
        assert ours.get_by_address(v.address) == (len(ours) - 1, v)


def test_evidence_hashes_and_checks_equal_reference(chains):
    from cometbft_tpu.types import evidence as rev
    from cometbft_tpu_torch.types import evidence as tev

    samples = _samples(chains[0])
    for name in ("DuplicateVoteEvidence", "LightClientAttackEvidence"):
        r = samples[name]
        t = tser.loads(rser.dumps(r))
        assert t.hash() == r.hash() and t.height() == r.height()
        assert t.time_ns() == r.time_ns()
        assert tev.evidence_list_hash([t, t]) == rev.evidence_list_hash(
            [r, r])
    dve = tser.loads(rser.dumps(samples["DuplicateVoteEvidence"]))
    swapped = dataclasses.replace(dve, vote_a=dve.vote_b, vote_b=dve.vote_a)
    with pytest.raises(tev.EvidenceError, match="ordered"):
        swapped.validate_basic()
    lca = tser.loads(rser.dumps(samples["LightClientAttackEvidence"]))
    lca.validate_basic()
    assert lca.conflicting_header_is_invalid(
        lca.conflicting_block.signed_header.header) is False


def test_converters_equal_the_codec_round_trip(chains):
    """convert.genesis_from, state_from, block_meta_from and
    abci_response_from give what ser.loads of the port makes of ser.dumps
    of the reference (the stored records), and the carried state encodes
    to the reference's bytes."""
    from cometbft_tpu.abci import codec as rc
    from cometbft_tpu.state import Store as RStore
    from cometbft_tpu_torch.abci import codec as tc
    from cometbft_tpu_torch.state import Store as TStore

    ref = chains[0]
    g = convert.genesis_from(ref.genesis)
    assert g.to_json() == ref.genesis.to_json() and g.hash() == \
        ref.genesis.hash()
    assert tser.dumps(g.consensus_params) == rser.dumps(
        ref.genesis.consensus_params)
    for h in (1, UPDATE_HEIGHT, HEIGHTS):
        s = ref.heights[h]["state"]
        carried = convert.state_from(s)
        assert TStore._encode_state(carried) == RStore._encode_state(s)
        assert _state_fields(carried) == _state_fields(
            TStore._decode_state(RStore._encode_state(s)))
        assert _state_fields(carried) == _state_fields(s)
        meta = ref.block_store.load_block_meta(h)
        assert convert.block_meta_from(meta) == tser.loads(rser.dumps(meta))
        resp = ref.heights[h]["resp"]
        got = convert.abci_response_from(resp)
        assert got == tc._from_jsonable(rc._to_jsonable(resp))
        assert tc._to_jsonable(got) == rc._to_jsonable(resp)
    blk = convert.block_from(ref.blocks[4])
    assert tser.dumps(blk) == rser.dumps(ref.blocks[4])


@pytest.mark.parametrize("seed", range(4))
def test_change_sets_rotate_as_reference(seed):
    """update_with_change_set (adds, power changes, removals, a rejected
    duplicate and unknown removal) and copy_increment_proposer_priority
    give the reference's priorities and proposers, round after round."""
    import random

    from cometbft_tpu.crypto.keys import Ed25519PubKey as RPub
    from cometbft_tpu.types.validator_set import (Validator as RV,
                                                  ValidatorSet as RVS)
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey as TPub
    from cometbft_tpu_torch.types.validator_set import (Validator as TV,
                                                        ValidatorSet as TVS)

    rng = random.Random(seed)
    keys = [hashlib.sha256(b"vs%d-%d" % (seed, i)).digest()
            for i in range(12)]
    powers = [rng.randrange(1, 1000) for _ in keys[:6]]
    r = RVS([RV(RPub(k), p) for k, p in zip(keys, powers)])
    t = TVS([TV(TPub(k), p) for k, p in zip(keys, powers)])
    for step in range(6):
        change = [(rng.choice(keys), rng.choice([0, rng.randrange(1, 5000)]))
                  for _ in range(rng.randrange(1, 4))]
        change = list(dict(change).items())
        outs = []
        for vs, V, P in ((r, RV, RPub), (t, TV, TPub)):
            try:
                vs.update_with_change_set([V(P(k), p) for k, p in change])
                outs.append(None)
            except ValueError as e:
                outs.append(str(e))
        assert outs[1] == outs[0]
        r = r.copy_increment_proposer_priority(1 + step % 3)
        t = t.copy_increment_proposer_priority(1 + step % 3)
        assert _valset(t) == _valset(r)
        assert t.get_proposer().address == r.get_proposer().address
        for v in t.validators:
            assert t.get_by_address(v.address)[1] is v
    dup = keys[0]
    for vs, V, P in ((r, RV, RPub), (t, TV, TPub)):
        with pytest.raises(ValueError, match="duplicate"):
            vs.update_with_change_set([V(P(dup), 1), V(P(dup), 2)])
        with pytest.raises(ValueError, match="unknown"):
            vs.update_with_change_set([V(P(b"\x09" * 32), 0)])


def test_make_extended_commit_equals_reference():
    """VoteSet.make_extended_commit over precommits with extensions (three
    for the block, one for nil) gives the reference's bytes; a nil
    signature may carry no extension."""
    out = []
    for pkg in ("cometbft_tpu", "cometbft_tpu_torch"):
        m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa
        keys, blk = m("crypto.keys"), m("types.block")
        vs_mod, vote_mod = m("types.vote_set"), m("types.vote")
        privs = [keys.Ed25519PrivKey.from_seed(_seed(i)) for i in range(N)]
        vals = m("types.validator_set").ValidatorSet([
            m("types.validator_set").Validator(p.pub_key(), 10)
            for p in privs])
        by_addr = {p.pub_key().address(): p for p in privs}
        bid = blk.BlockID(b"\x05" * 32, blk.PartSetHeader(2, b"\x06" * 32))
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        vs = vs_mod.VoteSet(CHAIN, 7, 0, 2, vals, extensions_enabled=True,
                            **kw)
        for i, v in enumerate(vals.validators):
            vote = vote_mod.Vote(2, 7, 0, bid if i < 3 else blk.NIL_BLOCK_ID,
                                 T0 + i, v.address, i,
                                 extension=b"x%d" % i if i < 3 else b"")
            m("types.priv_validator").MockPV(by_addr[v.address]).sign_vote(
                CHAIN, vote)
            vs.add_vote(vote)
        ec = vs.make_extended_commit(require_extensions=True)
        ec.validate_basic()
        assert ec.size() == N and ec.to_commit().hash() == \
            vs.make_commit().hash()
        assert [bool(es.extension_signature)
                for es in ec.extended_signatures] == [True] * 3 + [False]
        with pytest.raises(ValueError, match="extension"):
            blk.ExtendedCommitSig(blk.CommitSig(
                blk.BLOCK_ID_FLAG_NIL, b"\x01" * 20, T0, b"s"),
                b"e").validate_basic()
        out.append(m("types.serialization").dumps(ec))
    assert out[1] == out[0]
