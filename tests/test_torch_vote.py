"""The port's votes, vote sets and single-signature commit walk vs the JAX
package, on the CPU.

Votes are signed in the reference (its MockPV) and carried across with
convert.vote_from; validator sets with convert.validator_set_from_pairs.
Sign bytes of votes, extensions and proposals must be byte-equal. A mixed
admission corpus (valid votes, a corrupted signature, an address-spoofed
relay, an equivocation, a duplicate) goes through the reference's VoteSet
unrouted and through the port's unrouted and with a VerifyCoalescer
(device="cpu") pushed, its host tier and its device tier (the kernels'
plain versions) in turn: decisions, bit arrays, tallies, the latched
majority and make_commit must be the reference's, and the commit must
pass the port's verify_commit. types/validation._verify_single defers its
lanes to a pushed coalescer and still names the first invalid index
before a later failure, as the reference's unrouted walk does.
"""

import dataclasses

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from cometbft_tpu.types import canonical as jcanonical
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types.block import BLOCK_ID_FLAG_ABSENT as J_ABSENT
from cometbft_tpu.types.block import BLOCK_ID_FLAG_COMMIT as J_COMMIT
from cometbft_tpu.types.block import BlockID as JBlockID
from cometbft_tpu.types.block import Commit as JCommit
from cometbft_tpu.types.block import PartSetHeader as JPartSetHeader
from cometbft_tpu.types.priv_validator import MockPV
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.types.vote_set import VoteSet as JVoteSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import coalesce
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import canonical as tcanonical
from cometbft_tpu_torch.types import validation as tvalidation
from cometbft_tpu_torch.types.vote import Proposal, VoteError
from cometbft_tpu_torch.types.vote_set import VoteSet

CHAIN_ID = "port-vote-chain"
HEIGHT = 5
TIERS = {"host": 1 << 30, "device": 1}


@pytest.fixture(autouse=True)
def _cut(monkeypatch):
    """Both packages' host/device cut at 64 lanes: every batch here is
    below it, so batches route to the coalescer or the host batch in both
    (the routed cases pin the coalescer's own window cut)."""
    from cometbft_tpu.crypto import batch as jbatch
    from cometbft_tpu_torch.crypto import batch as tbatch

    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", 64)
    monkeypatch.setattr(jbatch, "HOST_BATCH_THRESHOLD", 64)


@pytest.fixture(autouse=True, scope="module")
def _module_state():
    """One torch thread (tiny tensors); a process-wide CPU arena of this
    module's own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = tverify._PUBKEY_CACHE
    tverify._PUBKEY_CACHE = {}
    yield
    tverify._PUBKEY_CACHE = saved
    torch.set_num_threads(threads)


def _valset(n, power=10):
    """(reference set, its MockPVs in set order, the port's set)."""
    pvs = [MockPV(JPrivKey.from_seed((900 + i).to_bytes(32, "big")))
           for i in range(n)]
    vals = JValidatorSet([JValidator(pv.get_pub_key(), voting_power=power)
                          for pv in pvs])
    by_addr = {bytes(pv.get_pub_key().address()): pv for pv in pvs}
    ordered = [by_addr[bytes(v.address)] for v in vals.validators]
    t_vals = convert.validator_set_from_pairs(
        (v.pub_key.data, v.voting_power) for v in vals.validators)
    return vals, ordered, t_vals


def _block_id(tag=1) -> JBlockID:
    return JBlockID(hash=bytes([tag]) * 32,
                    part_set_header=JPartSetHeader(total=1, hash=bytes(32)))


def _vote(vals, pvs, idx, msg_type=jcanonical.PREVOTE_TYPE, tag=1,
          extension=b""):
    v = JVote(msg_type=msg_type, height=HEIGHT, round=0,
              block_id=_block_id(tag),
              timestamp_ns=1_700_000_000_000_000_000 + idx,
              validator_address=vals.validators[idx].address,
              validator_index=idx, extension=extension)
    pvs[idx].sign_vote(CHAIN_ID, v, sign_extension=bool(extension))
    return v


def _corpus(vals, pvs, msg_type=jcanonical.PREVOTE_TYPE):
    """Invalid votes first (their slots still empty), then every valid
    vote, an equivocation and an exact duplicate."""
    votes = [_vote(vals, pvs, i, msg_type) for i in range(len(pvs))]
    return [
        dataclasses.replace(votes[0], signature=bytes(64)),
        # validator 1's validly signed bytes claimed under validator 2's
        # slot: the signature check against 2's key rejects it
        dataclasses.replace(votes[1], validator_index=2,
                            validator_address=vals.validators[2].address),
        *votes,
        _vote(vals, pvs, 3, msg_type, tag=2),
        votes[4],
    ]


def _decisions(vs, corpus, batch):
    if batch:
        added, errs = vs.add_votes_batch(corpus)
        return list(zip(added, [type(e).__name__ if e else None
                                for e in errs]))
    out = []
    for vote in corpus:
        try:
            out.append((vs.add_vote(vote), None))
        except Exception as e:
            out.append((False, type(e).__name__))
    return out


def _state(vs):
    bits = vs.bit_array()
    return ([bits.get_index(i) for i in range(bits.size())], vs.sum,
            vs.has_two_thirds_majority(), vs.has_two_thirds_any(),
            vs.has_all())


@pytest.fixture
def routed():
    """routed(tier) pushes a CPU VerifyCoalescer of that tier; popped and
    stopped after the case."""
    made = []

    def push(tier):
        co = coalesce.VerifyCoalescer(device="cpu", window_us=2_000,
                                      max_lanes=64,
                                      min_device_lanes=TIERS[tier])
        co.start()
        coalesce.push_active(co)
        made.append(co)
        return co

    yield push
    for co in made:
        coalesce.pop_active(co)
        co.stop()


# -- sign bytes ------------------------------------------------------------


@pytest.mark.parametrize("msg_type", [1, 2, 32, 0])
def test_vote_type_predicate_matches_reference(msg_type):
    assert tcanonical.is_vote_type(msg_type) == jcanonical.is_vote_type(
        msg_type)


@pytest.mark.parametrize("nil", [False, True])
def test_sign_bytes_are_the_references(nil):
    vals, pvs, _ = _valset(2)
    j = _vote(vals, pvs, 1, jcanonical.PRECOMMIT_TYPE, extension=b"ext")
    if nil:
        j = dataclasses.replace(j, block_id=JBlockID(), extension=b"")
    t = convert.vote_from(j)
    assert t.sign_bytes(CHAIN_ID) == j.sign_bytes(CHAIN_ID)
    assert t.extension_sign_bytes(CHAIN_ID) == j.extension_sign_bytes(
        CHAIN_ID)
    assert t.commit_sig() == convert.commit_from(JCommit(
        HEIGHT, 0, j.block_id, [j.commit_sig()])).signatures[0]
    for pol_round, round_ in ((-1, 0), (0, 3), (2, 7)):
        jp = JProposal(HEIGHT, round_, pol_round, _block_id(3),
                       1_700_000_000_123_456_789)
        tp = Proposal(HEIGHT, round_, pol_round,
                      convert._block_id(jp.block_id), jp.timestamp_ns)
        assert tp.sign_bytes(CHAIN_ID) == jp.sign_bytes(CHAIN_ID)
        tp.signature = b"\x01" * 64
        tp.validate_basic()


# -- admission identity ----------------------------------------------------


@pytest.mark.parametrize("mode", ["unrouted", "host", "device"])
@pytest.mark.parametrize("batch", [False, True])
def test_vote_set_admission_matches_reference(routed, mode, batch):
    vals, pvs, t_vals = _valset(6)
    corpus = _corpus(vals, pvs)
    ref_vs = JVoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PREVOTE_TYPE, vals)
    want = _decisions(ref_vs, corpus, batch)
    kinds = {k for _, k in want}
    assert {"VoteError", "ConflictingVoteError"} <= kinds
    assert (True, None) in want and (False, None) in want
    co = routed(mode) if mode != "unrouted" else None
    vs = VoteSet(CHAIN_ID, HEIGHT, 0, tcanonical.PREVOTE_TYPE, t_vals,
                 device="cpu")
    got = _decisions(vs, [convert.vote_from(v) for v in corpus], batch)
    assert got == want
    assert _state(vs) == _state(ref_vs)
    assert vs.two_thirds_majority() == convert._block_id(
        ref_vs.two_thirds_majority())
    if co is not None:
        assert co.tickets >= 1
        assert (co.device_windows > 0) == (mode == "device")


@pytest.mark.parametrize("mode", ["unrouted", "device"])
def test_precommits_make_the_references_commit(routed, mode):
    """A precommit set with extensions: every vote through
    add_votes_batch (vote and extension lanes), one nil vote, one absent
    validator; make_commit equals the reference's and passes the port's
    verify_commit."""
    vals, pvs, t_vals = _valset(7)
    votes = [_vote(vals, pvs, i, jcanonical.PRECOMMIT_TYPE, extension=b"x")
             for i in range(6)]
    nil = JVote(jcanonical.PRECOMMIT_TYPE, HEIGHT, 0, JBlockID(),
                1_700_000_000_000_000_099, vals.validators[5].address, 5)
    pvs[5].sign_vote(CHAIN_ID, nil, sign_extension=False)
    votes[5] = nil
    bad_ext = dataclasses.replace(votes[2], extension_signature=bytes(64))
    corpus = [bad_ext] + votes
    ref_vs = JVoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE, vals,
                      extensions_enabled=True)
    want = _decisions(ref_vs, corpus, batch=True)
    assert want[0] == (False, "VoteError")
    if mode != "unrouted":
        routed(mode)
    vs = VoteSet(CHAIN_ID, HEIGHT, 0, tcanonical.PRECOMMIT_TYPE, t_vals,
                 extensions_enabled=True, device="cpu")
    assert _decisions(vs, [convert.vote_from(v) for v in corpus],
                      batch=True) == want
    commit = vs.make_commit()
    assert commit == convert.commit_from(ref_vs.make_commit())
    assert [cs.block_id_flag for cs in commit.signatures].count(
        tblock.BLOCK_ID_FLAG_ABSENT) == 1
    tvalidation.verify_commit(CHAIN_ID, t_vals, commit.block_id, HEIGHT,
                              commit, device="cpu")


def test_vote_set_state_carries_across():
    """convert.vote_set_from copies the reference's admitted state: the
    same queries, the same commit, the same next decisions."""
    vals, pvs, _ = _valset(5)
    ref_vs = JVoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE, vals)
    for i in range(4):
        ref_vs.add_vote(_vote(vals, pvs, i, jcanonical.PRECOMMIT_TYPE))
    ref_vs.set_peer_maj23("peer", _block_id(2))
    vs = convert.vote_set_from(ref_vs, device="cpu")
    assert _state(vs) == _state(ref_vs)
    assert vs.make_commit() == convert.commit_from(ref_vs.make_commit())
    # a conflicting vote for the peer-claimed block is admitted by both
    late = _vote(vals, pvs, 1, jcanonical.PRECOMMIT_TYPE, tag=2)
    assert vs.add_vote(convert.vote_from(late)) == ref_vs.add_vote(late)
    assert (vs.bit_array_by_block_id(convert._block_id(_block_id(2)))
            .get_true_indices()
            == ref_vs.bit_array_by_block_id(_block_id(2)).get_true_indices())


@pytest.mark.parametrize("mode", ["unrouted", "host"])
def test_vote_verify_routes_and_rejects(routed, monkeypatch, mode):
    """Vote.verify and verify_extension: the pushed coalescer takes the
    signature (the key's own verify_signature is not asked), unrouted the
    key does; a tampered vote raises VoteError either way."""
    vals, pvs, t_vals = _valset(3)
    j = _vote(vals, pvs, 1, jcanonical.PRECOMMIT_TYPE, extension=b"e")
    t = convert.vote_from(j)
    key = t_vals.validators[1].pub_key
    co = routed(mode) if mode != "unrouted" else None
    if co is not None:
        monkeypatch.setattr(type(key), "verify_signature", None)
    t.verify_vote_and_extension(CHAIN_ID, key)
    with pytest.raises(VoteError, match="invalid signature"):
        dataclasses.replace(t, signature=bytes(64)).verify(CHAIN_ID, key)
    with pytest.raises(VoteError, match="invalid extension signature"):
        dataclasses.replace(t, extension=b"f").verify_extension(CHAIN_ID,
                                                                key)
    with pytest.raises(VoteError, match="invalid validator address"):
        t.verify(CHAIN_ID, t_vals.validators[0].pub_key)
    if co is not None:
        assert co.tickets == 4


# -- the single-signature walk (the fault: no coalescer hook) ---------------


def _commit(n, bad=(), dup=None):
    """(reference set, port set, reference commit, port commit)."""
    vals, pvs, t_vals = _valset(n)
    sigs = [_vote(vals, pvs, i, jcanonical.PRECOMMIT_TYPE).commit_sig()
            for i in range(n)]
    for i in bad:
        sigs[i] = dataclasses.replace(sigs[i], signature=bytes(64))
    if dup is not None:
        sigs[dup[1]] = sigs[dup[0]]
    commit = JCommit(HEIGHT, 0, _block_id(1), sigs)
    return vals, t_vals, commit, convert.commit_from(commit)


def _single(mod, vals, commit, by_index):
    needed = vals.total_voting_power() * 2 // 3
    try:
        mod._verify_single(
            CHAIN_ID, vals, commit, needed,
            lambda cs: cs.block_id_flag == J_ABSENT,
            lambda cs: cs.block_id_flag == J_COMMIT,
            count_all=True, by_index=by_index)
    except mod.VerificationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["valid", "inline_after", "double_vote"])
def test_single_walk_defers_and_names_the_first_invalid(routed, monkeypatch,
                                                        case):
    """Routed, the eligible lanes of the walk go to the coalescer in one
    ticket; the error is the reference's unrouted one: an invalid deferred
    lane (#1) is named before a later inline failure (#3, a key made
    ineligible) or a later double vote (#2 again at #4)."""
    bad = {"valid": (), "inline_after": (1, 3), "double_vote": (1,)}[case]
    dup = (2, 4) if case == "double_vote" else None
    vals, t_vals, commit, t_commit = _commit(5, bad, dup)
    by_index = case != "double_vote"
    want = _single(jvalidation, vals, commit, by_index)
    if case != "valid":
        assert "(#1)" in want
    if case == "inline_after":
        ineligible = t_vals.validators[3].pub_key.data
        real = coalesce.eligible
        monkeypatch.setattr(coalesce, "eligible",
                            lambda pk: pk.data != ineligible and real(pk))
    assert _single(tvalidation, t_vals, t_commit, by_index) == want
    co = routed("host")
    calls = []
    real_many = thost.verify_many
    monkeypatch.setattr(thost, "verify_many",
                        lambda *a: calls.append(len(a[0])) or real_many(*a))
    assert _single(tvalidation, t_vals, t_commit, by_index) == want
    assert co.tickets == 1 and calls  # one deferred group, through a window
    if case == "valid":
        assert calls == [5]  # all five lanes in the one window
