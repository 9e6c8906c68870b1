"""The port's evidence pool and verification (cometbft_tpu_torch/evidence)
and state rollback (state/rollback.py) against the JAX package's, on the
same seeded chains, exactly.

Each package runs its own 4-validator chain from one genesis (MemDB
stores, the kvstore on a local client); the port's with
``device="cpu"``. The light-client attack's trusting check runs the
port's plain K2 (the verify cut pinned to 2, a fresh arena).
"""

import dataclasses
import importlib

import pytest

from cometbft_tpu_torch import convert

CHAIN_ID = "evidence-chain"
T0 = 1_700_000_000_000_000_000
N_VALS = 4


class Rig:
    """One package's chain: genesis, stores, executor, evidence pool, and
    the signers in the validator set's order."""

    def __init__(self, pkg: str):
        m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.m = m
        self.t = m("types")
        keys = m("crypto.keys")
        dev = {"device": "cpu"} if pkg == "cometbft_tpu_torch" else {}
        pvs = [self.t.MockPV(keys.Ed25519PrivKey.from_seed(bytes([i + 1])
                                                           * 32))
               for i in range(N_VALS)]
        self.genesis = self.t.GenesisDoc(
            chain_id=CHAIN_ID, genesis_time_ns=T0,
            validators=[self.t.GenesisValidator(pub_key=pv.get_pub_key(),
                                                power=10) for pv in pvs])
        by = {bytes(pv.get_pub_key().address()): pv for pv in pvs}
        self.pvs = [by[v.address] for v in
                    self.genesis.validator_set().validators]
        dbm, st = m("libs.db"), m("state")
        self.app = m("abci.kvstore").KVStoreApplication()
        self.conns = m("proxy").AppConns(m("proxy").local_client_creator(
            self.app))
        self.conns.start()
        self.state_store = st.Store(dbm.MemDB())
        self.block_store = m("store").BlockStore(dbm.MemDB())
        self.ev_db = dbm.MemDB()
        self.pool = m("evidence").EvidencePool(
            self.ev_db, self.state_store, self.block_store, **dev)
        self.exe = st.BlockExecutor(
            self.state_store, self.conns.consensus, evidence_pool=self.pool,
            block_store=self.block_store, **dev)
        self.state = st.make_genesis_state(self.genesis)
        self.state_store.save(self.state)
        self.last_commit = None

    def produce(self, txs=(), evidence=()):
        """One height through apply_block, its commit signed by all."""
        ser = self.m("types.serialization")
        h = self.state.last_block_height + 1
        proposer = self.state.validators.get_proposer()
        blk = self.state.make_block(h, list(txs), self.last_commit,
                                    list(evidence), proposer.address,
                                    T0 + h * 10**9)
        parts = self.t.PartSet.from_data(ser.dumps(blk))
        bid = self.t.BlockID(blk.hash(), parts.header)
        sigs = []
        for i, (v, pv) in enumerate(zip(self.state.validators.validators,
                                        self.pvs)):
            vote = self.t.Vote(msg_type=self.t.PRECOMMIT_TYPE, height=h,
                               round=0, block_id=bid,
                               timestamp_ns=T0 + h * 10**9 + 1 + i,
                               validator_address=v.address,
                               validator_index=i)
            pv.sign_vote(CHAIN_ID, vote, sign_extension=False)
            sigs.append(vote.commit_sig())
        self.state = self.exe.apply_block(self.state, bid, blk)
        commit = self.t.Commit(height=h, round=0, block_id=bid,
                               signatures=sigs)
        self.block_store.save_block(blk, parts, commit)
        self.last_commit = commit
        return blk

    def double_vote(self, idx, height, tags=(b"\xaa", b"\xbb")):
        votes = []
        v = self.state.validators.validators[idx]
        for tag in tags:
            vote = self.t.Vote(
                msg_type=self.t.PRECOMMIT_TYPE, height=height, round=0,
                block_id=self.t.BlockID(tag * 32,
                                        self.t.PartSetHeader(1, tag * 32)),
                timestamp_ns=T0 + 7, validator_address=v.address,
                validator_index=idx)
            self.pvs[idx].sign_vote(CHAIN_ID, vote, sign_extension=False)
            votes.append(vote)
        return votes

    def close(self):
        self.conns.stop()


def outcome(fn, *args, **kwargs):
    """"ok" (or the return value) or the exception's class and message."""
    try:
        out = fn(*args, **kwargs)
        return "ok" if out is None else out
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


@pytest.fixture
def rigs():
    out = (Rig("cometbft_tpu"), Rig("cometbft_tpu_torch"))
    for r in out:
        r.produce([b"seed=1"])
    yield out
    for r in out:
        r.close()


def _dup_cases(r):
    """The duplicate-vote evidence cases of rig ``r``: valid, wrong power,
    wrong total, a bad signature, the same block twice, a stranger."""
    ev_mod = r.m("types.evidence")
    vals = r.state.validators
    v1, v2 = r.double_vote(0, 1)
    ev = ev_mod.DuplicateVoteEvidence.from_conflicting_votes(
        v1, v2, r.state.last_block_time_ns, vals)
    same = r.double_vote(1, 1, tags=(b"\xcc", b"\xcc"))
    stranger = r.t.Validator(
        r.m("crypto.keys").Ed25519PrivKey.from_seed(b"\x77" * 32).pub_key(),
        10)
    return {
        "valid": ev,
        "wrong_power": dataclasses.replace(ev, validator_power=11),
        "wrong_total": dataclasses.replace(ev, total_voting_power=41),
        "bad_signature": dataclasses.replace(
            ev, vote_b=dataclasses.replace(ev.vote_b,
                                           signature=b"\x01" * 64)),
        "same_block": ev_mod.DuplicateVoteEvidence(
            vote_a=same[0], vote_b=same[1], total_voting_power=40,
            validator_power=10, timestamp_ns=ev.timestamp_ns),
        "stranger": dataclasses.replace(ev, vote_a=dataclasses.replace(
            ev.vote_a, validator_address=stranger.address)),
    }


def test_verify_duplicate_vote_cases_equal_the_reference(rigs):
    ref, port = rigs
    rc, pc = _dup_cases(ref), _dup_cases(port)
    got = {}
    for name in rc:
        got[name] = (
            outcome(ref.m("evidence").verify_duplicate_vote, rc[name],
                    CHAIN_ID, ref.state.validators),
            outcome(port.m("evidence").verify_duplicate_vote, pc[name],
                    CHAIN_ID, port.state.validators))
        assert pc[name].hash() == rc[name].hash()
    assert {n: a for n, (a, _) in got.items()} == {
        n: b for n, (_, b) in got.items()}
    assert got["valid"][0] == "ok"
    assert all(a != "ok" for n, (a, _) in got.items() if n != "valid")


def _pool_trace(r):
    """The pool's lifecycle on rig ``r``: each step's observation and the
    pool DB's contents after it."""
    ev_mod = r.m("types.evidence")
    vals = r.state.validators
    evs = [ev_mod.DuplicateVoteEvidence.from_conflicting_votes(
        *r.double_vote(i, 1), r.state.last_block_time_ns, vals)
        for i in (1, 2)]
    trace = []

    def note(*obs):
        trace.append((obs, sorted(r.ev_db.iterator())))
    note(outcome(r.pool.add_evidence, evs[0]), r.pool.is_pending(evs[0]))
    note(outcome(r.pool.add_evidence, evs[0]))  # idempotent
    note([e.hash() for e in r.pool.pending_evidence(-1)],
         [e.hash() for e in r.pool.pending_evidence(10)])
    note(outcome(r.pool.check_evidence, [evs[0]]),
         outcome(r.pool.check_evidence, [evs[1]]),
         outcome(r.pool.check_evidence, [evs[0], evs[0]]))
    note(outcome(r.pool.add_evidence, evs[1]))
    blk = r.produce([b"two=2"], evidence=[evs[0]])  # commits evs[0]
    note([e.hash() for e in blk.evidence], r.pool.is_committed(evs[0]),
         r.pool.is_pending(evs[0]), r.pool.is_pending(evs[1]),
         outcome(r.pool.check_evidence, [evs[0]]))
    # expiry: a state past both age limits prunes the pending one
    old = r.state.copy()
    old.last_block_height += old.consensus_params.evidence.max_age_num_blocks + 5
    old.last_block_time_ns += (
        old.consensus_params.evidence.max_age_duration_ns + 10**9)
    r.pool.update(old, [])
    note(r.pool.is_pending(evs[1]),
         [e.hash() for e in r.pool.pending_evidence(-1)],
         outcome(r.m("evidence").verify_evidence, evs[1], old, vals))
    return trace


def test_pool_lifecycle_equals_the_reference(rigs):
    ref, port = rigs
    assert _pool_trace(port) == _pool_trace(ref)


def test_report_conflicting_votes_equals_the_reference(rigs):
    out = []
    for r in rigs:
        v1, v2 = r.double_vote(3, 1)
        r.pool.report_conflicting_votes(v1, v2)
        r.pool.report_conflicting_votes(v2, v1)  # the same evidence
        stranger = dataclasses.replace(v1, height=99)  # no set stored
        r.pool.report_conflicting_votes(stranger, v2)
        out.append(([e.hash() for e in r.pool.pending_evidence(-1)],
                    sorted(r.ev_db.iterator())))
    assert out[1] == out[0] and len(out[0][0]) == 1


def _light_attack(r, signers, tamper=None):
    """A header forged at height 2 over rig ``r``'s height-1 block, its
    commit signed by the first ``signers`` validators."""
    tb = r.t
    ev_mod = r.m("types.evidence")
    trusted = r.block_store.load_block(1).header
    header = dataclasses.replace(trusted, height=2,
                                 time_ns=trusted.time_ns + 10**9,
                                 app_hash=b"\x42" * 32)
    bid = tb.BlockID(header.hash(), tb.PartSetHeader(1, b"\x24" * 32))
    vals = r.state_store.load_validators(1)
    sigs = []
    for i, v in enumerate(vals.validators[:signers]):
        vote = tb.Vote(msg_type=tb.PRECOMMIT_TYPE, height=2, round=0,
                       block_id=bid, timestamp_ns=header.time_ns + i,
                       validator_address=v.address, validator_index=i)
        r.pvs[i].sign_vote(CHAIN_ID, vote, sign_extension=False)
        sig = vote.commit_sig()
        if i == tamper:
            sig = dataclasses.replace(sig, signature=bytes(
                [sig.signature[0] ^ 1]) + sig.signature[1:])
        sigs.append(sig)
    commit = tb.Commit(height=2, round=0, block_id=bid, signatures=sigs)
    return ev_mod.LightClientAttackEvidence(
        conflicting_block=tb.LightBlock(tb.SignedHeader(header, commit),
                                        vals),
        common_height=1, byzantine_validators=list(vals.validators[:signers]),
        total_voting_power=vals.total_voting_power(),
        timestamp_ns=trusted.time_ns)


def test_light_client_attack_verdicts_equal_the_reference(rigs,
                                                          monkeypatch):
    """Two of four signers pass the 1/3 trusting check, one does not, a
    spoiled signature is named; the port's check runs the plain K2 (and X1
    for the arena), the reference's its own path."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import curve
    from cometbft_tpu_torch.ops import verify as ov

    monkeypatch.setattr(batch, "HOST_BATCH_THRESHOLD", 2)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    k2_lanes = []
    real = curve.verify_kernel_slots

    def plain_k2(arena, arena_ok, idxs, *args, **kw):
        k2_lanes.append(int(idxs.shape[0]))
        return real(arena, arena_ok, idxs, *args, **kw)
    monkeypatch.setattr(curve, "verify_kernel_slots", plain_k2)
    ref, port = rigs
    got = []
    for signers, tamper in ((2, None), (1, None), (3, 1)):
        rev = _light_attack(ref, signers, tamper)
        pev = _light_attack(port, signers, tamper)
        assert convert.evidence_from(rev).hash() == pev.hash() == rev.hash()
        got.append((outcome(ref.pool.verify, rev),
                    outcome(port.pool.verify, pev)))
    assert [a for a, _ in got] == [b for _, b in got]
    assert got[0][0] == "ok" and got[1][0] != "ok" and got[2][0] != "ok"
    # the single-signer case stops short of the trust level before any
    # launch; the other two ran K2's plain version on their lanes
    assert len(k2_lanes) == 2 and min(k2_lanes) >= 2


def test_rollback_state_equals_the_reference(rigs):
    out = []
    for r in rigs:
        r.produce([b"a=1"])
        r.produce([b"b=2"])
        rb = r.m("state.rollback")
        first = rb.rollback_state(r.state_store, r.block_store)
        st = r.state_store.load()
        second = outcome(rb.rollback_state, r.state_store, r.block_store,
                         remove_block=True)
        st2 = r.state_store.load()
        enc = r.m("state").Store._encode_state
        out.append((first, enc(st), second, enc(st2),
                    r.block_store.height()))
    assert out[1] == out[0]
    assert out[0][0][0] == 2


def test_evidence_pool_defaults_to_cuda_and_raises_without_a_gpu():
    import torch

    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs import db as dbm

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        EvidencePool(dbm.MemDB(), None, None)
