"""The port's sr25519 and mixed batch verification vs the JAX package, on
the CPU.

Wire rows (ops.verify.pack_part_row, pack_parts and MixedBatchVerifier's
row assembly) must be the reference's byte for byte. Sr25519BatchVerifier
and MixedBatchVerifier verdict bitmaps over seeded lanes with tampered and
malformed ones must equal the reference's, below the host/device cut (the
native RLC batch) and at it (device="cpu": K2's plain version on the
process-wide CPU arena, or K1's with COMETBFT_TPU_PUBKEY_CACHE=0), each
route checked by the launcher it takes. create_commit_batch_verifier picks
the reference's backend for ed25519, sr25519, mixed and secp256k1 sets;
verify_commit on a mixed set names the reference's index in the
reference's words; a mixed VoteSet.add_votes_batch and a secp256k1 set
(one vote at a time) decide as the reference's (the secp256k1 comparison
only where the ``cryptography`` wheel is installed); ValidatorSet.hash is
the reference's for secp256k1 keys and raises for sr25519 as it does
there.
"""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu.types import canonical as jcanonical
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types.block import BLOCK_ID_FLAG_COMMIT as J_COMMIT
from cometbft_tpu.types.block import BlockID as JBlockID
from cometbft_tpu.types.block import Commit as JCommit
from cometbft_tpu.types.block import CommitSig as JCommitSig
from cometbft_tpu.types.block import PartSetHeader as JPartSetHeader
from cometbft_tpu.types.validator_set import Validator as JValidator
from cometbft_tpu.types.validator_set import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.types.vote_set import VoteSet as JVoteSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import coalesce
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.types import validation as tvalidation
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import VoteError
from cometbft_tpu_torch.types.vote_set import VoteSet

from helpers import HAVE_CRYPTOGRAPHY

CHAIN_ID = "port-mixed-chain"
HEIGHT = 9


@pytest.fixture(autouse=True, scope="module")
def _module_state():
    """One torch thread (tiny tensors), and a process-wide CPU arena of
    this module's own, so its device windows share X1's tables."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = tverify._PUBKEY_CACHE
    tverify._PUBKEY_CACHE = {}
    yield
    tverify._PUBKEY_CACHE = saved
    torch.set_num_threads(threads)


def _ed_seed(i: int) -> bytes:
    return hashlib.sha256(b"mixed test ed %d" % i).digest()


def _sr_mini(i: int) -> bytes:
    return hashlib.sha256(b"mixed test sr %d" % i).digest()


_PUBS: dict[tuple[str, int], bytes] = {}


def _key(kind: str, i: int):
    """(port pubkey, reference pubkey, signer) of seeded key i."""
    if (kind, i) not in _PUBS:
        _PUBS[(kind, i)] = (ref.pubkey_from_seed(_ed_seed(i))
                            if kind == "ed" else
                            tsr.public_from_mini(_sr_mini(i)))
    pub = _PUBS[(kind, i)]
    if kind == "ed":
        return (Ed25519PubKey(pub), jkeys.Ed25519PubKey(pub),
                lambda m: ref.sign(_ed_seed(i), m))
    return (tsr.Sr25519PubKey(pub), jsr.Sr25519PubKey(pub),
            lambda m: tsr.sign(_sr_mini(i), m))


def _flip(sig: bytes, at: int = 40) -> bytes:
    return sig[:at] + bytes([sig[at] ^ 1]) + sig[at + 1:]


def _sr_lanes():
    """12 sr25519 lanes: a flipped s bit (2), a wrong message (5), no
    marker bit (8), s >= L (10)."""
    lanes = []
    for i in range(12):
        pk, jpk, sign = _key("sr", i)
        msg = b"sr lane %d" % i
        sig = sign(msg)
        if i == 2:
            sig = _flip(sig)
        if i == 5:
            msg += b"!"
        if i == 8:
            sig = sig[:63] + bytes([sig[63] & 0x7F])
        if i == 10:
            sig = sig[:32] + (tsr.L | 1 << 255).to_bytes(32, "little")
        lanes.append((pk, jpk, msg, sig))
    return lanes


def _mixed_lanes():
    """16 lanes alternating ed25519 and sr25519: ed lanes with a flipped
    signature bit (2), S >= L (6), a truncated signature (10); sr lanes
    with a wrong message (5) and a non-canonical R (13)."""
    lanes = []
    for i in range(16):
        kind = "ed" if i % 2 == 0 else "sr"
        pk, jpk, sign = _key(kind, 50 + i)
        msg = b"mixed lane %d" % i
        sig = sign(msg)
        if i == 2:
            sig = _flip(sig, 3)
        if i == 6:
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        if i == 10:
            sig = sig[:40]
        if i == 5:
            msg += b"!"
        if i == 13:
            sig = (tsr.P + 2).to_bytes(32, "little") + sig[32:]
        lanes.append((pk, jpk, msg, sig))
    return lanes


LANES = {"sr25519": _sr_lanes, "mixed": _mixed_lanes}
WANT = {"sr25519": [i not in (2, 5, 8, 10) for i in range(12)],
        "mixed": [i not in (2, 5, 6, 10, 13) for i in range(16)]}


def _verifiers(kind, lanes, **kw):
    if kind == "sr25519":
        ours = tbatch.Sr25519BatchVerifier(**kw)
        theirs = jbatch.Sr25519BatchVerifier()
    else:
        ours = tbatch.MixedBatchVerifier(**kw)
        theirs = jbatch.MixedBatchVerifier()
    for pk, jpk, msg, sig in lanes:
        ours.add(pk, msg, sig)
        theirs.add(jpk, msg, sig)
    return ours, theirs


# -- the wire -----------------------------------------------------------------


def test_pack_part_row_and_pack_parts_are_the_references():
    lanes = _mixed_lanes()
    ours, theirs = _verifiers("mixed", lanes, device="cpu")
    quads = ours._quads()
    assert quads == theirs._quads()
    assert [q is None for q in quads] == [i in (6, 10, 13)
                                          for i in range(16)]
    for q in quads:
        if q is not None:
            assert tverify.pack_part_row(*q) == jverify.pack_part_row(*q)
    buf, host_ok = tverify.pack_parts(quads)
    jbuf, jhost_ok = jverify.pack_parts(quads)
    assert buf.dtype == np.uint8 and buf.shape == (128, 16)
    assert buf.tobytes() == jbuf.tobytes()
    assert np.array_equal(host_ok, jhost_ok)
    assert not buf[:, ~host_ok].any()  # rejected lanes ship zero rows


def test_mixed_row_assembly_is_pack_part_row_and_the_references():
    """The ed25519 rows (ops/verify.pack_bytes) and the sr25519 rows
    (pack_parts, through pack_part_row) are one layout, byte for byte the
    reference's, keyed by the Edwards encodings."""
    lanes = _mixed_lanes()
    ours, theirs = _verifiers("mixed", lanes, device="cpu")
    buf, host_ok, a_keys = ours._pack_rows()
    jbuf, jhost_ok, ja_keys = theirs._pack_rows()
    assert buf.tobytes() == jbuf.tobytes()
    assert np.array_equal(host_ok, jhost_ok)
    assert a_keys == ja_keys
    for i, q in enumerate(ours._quads()):
        if q is None:
            assert a_keys[i] == b"" and not host_ok[i]
            continue
        assert buf[:, i].tobytes() == tverify.pack_part_row(*q)
        assert a_keys[i] == bytes(q[0])
        if i % 2 == 0:  # ed25519: the key itself
            assert a_keys[i] == lanes[i][0].data
        else:  # sr25519: the ristretto key's Edwards encoding
            assert a_keys[i] == ref.compress(
                tsr.ristretto_decode(lanes[i][0].data))


# -- verdict bitmaps, routes ----------------------------------------------------

ROUTES = ("host", "device cached", "device uncached")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ("sr25519", "mixed"))
def test_batch_verifier_bitmaps_equal_the_references(monkeypatch, kind,
                                                     route):
    lanes = LANES[kind]()
    n = len(lanes)
    # at the cut the batch goes to the device, one below it to the host
    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD",
                        n + 1 if route == "host" else n)
    monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE",
                       "0" if route == "device uncached" else "1")
    taken = []
    for name in ("verify_rsk_async", "verify_bytes_async"):
        real = getattr(tverify, name)
        monkeypatch.setattr(tverify, name, lambda *a, _n=name, _r=real,
                            **k: taken.append(_n) or _r(*a, **k))
    real_quads = thost.verify_quads
    monkeypatch.setattr(thost, "verify_quads",
                        lambda q: taken.append("verify_quads")
                        or real_quads(q))
    ours, theirs = _verifiers(kind, lanes, device="cpu")
    ok, bits = ours.verify()
    jok, jbits = theirs.verify()
    assert list(map(bool, bits)) == jbits == WANT[kind]
    assert ok is jok is False
    assert taken == {"host": ["verify_quads"],
                     "device cached": ["verify_rsk_async"],
                     "device uncached": ["verify_bytes_async"]}[route]


def test_rejected_lane_keys_keep_their_arena_ok_bit_false():
    """A host-rejected lane carries key b"" and a zero row: the arena's ok
    bit keeps it False, while uncached the zero row decodes to a
    small-order point the cofactored equation accepts, which is why every
    caller ANDs its host checks in."""
    pk, _, sign = _key("ed", 0)
    buf, host_ok = tverify.pack_parts([
        (pk.data, sign(b"m")[:32], int.from_bytes(sign(b"m")[32:], "little"),
         ref.challenge_scalar(sign(b"m")[:32], pk.data, b"m")), None])
    assert host_ok.tolist() == [True, False]
    cache = tverify.PubkeyTableCache(device="cpu", capacity=4)
    cached = tverify.verify_prepacked(buf, [pk.data, b""], 2, device="cpu",
                                      cache=cache)()
    assert cached.tolist() == [True, False]
    slot = cache._slots[b""]
    assert not bool(cache.arena()[1][slot])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COMETBFT_TPU_PUBKEY_CACHE", "0")
        uncached = tverify.verify_prepacked(buf, [pk.data, b""], 2,
                                            device="cpu")()
    assert uncached.tolist() == [True, True]
    with pytest.raises(ValueError, match="128"):
        tverify.verify_prepacked(buf[:, :1], [pk.data, b""], 2, device="cpu")
    assert tverify.verify_prepacked(buf[:, :0], [], 0, device="cpu")(
        ).tolist() == []


# -- validator sets ---------------------------------------------------------------


def _vals(kinds, power=10):
    """(port set, reference set, signer by address) of seeded keys."""
    ours, theirs, signer = [], [], {}
    for j, kind in enumerate(kinds):
        if kind == "secp":
            priv = tsecp.Secp256k1PrivKey.from_seed(b"secp %d" % j)
            pk = priv.pub_key()
            from cometbft_tpu.crypto.secp256k1 import Secp256k1PubKey

            jpk = Secp256k1PubKey(pk.data)
            sign = priv.sign
        else:
            pk, jpk, sign = _key(kind, 100 + j)
        ours.append(Validator(pk, power))
        theirs.append(JValidator(jpk, power))
        signer[bytes(pk.address())] = sign
    return ValidatorSet(ours), JValidatorSet(theirs), signer


MIXED12 = ["ed", "sr"] * 6


def test_commit_batch_verifier_choices_are_the_references():
    cases = {
        "ed25519": ["ed", "ed"],
        "sr25519": ["sr", "sr"],
        "mixed": ["ed", "sr", "ed"],
        "secp256k1": ["secp", "secp"],
        "ed25519 + secp256k1": ["ed", "secp"],
    }
    for name, kinds in cases.items():
        ours_vals, their_vals, _ = _vals(kinds)
        assert (tbatch.supports_commit_batch(ours_vals)
                == jbatch.supports_commit_batch(their_vals)), name
        try:
            want = type(jbatch.create_commit_batch_verifier(their_vals))
        except ValueError:
            with pytest.raises(ValueError, match="unsupported"):
                tbatch.create_commit_batch_verifier(ours_vals, device="cpu")
            continue
        got = tbatch.create_commit_batch_verifier(ours_vals, device="cpu",
                                                  flavor="4")
        assert type(got).__name__ == want.__name__, name
        assert (got.device, got.pubkey_cache, got.flavor) == ("cpu", None,
                                                              "4")
    assert not tbatch.supports_commit_batch(_vals(["secp", "secp"])[0])
    assert tbatch.supports_commit_batch(_vals(MIXED12)[0])


def test_validator_set_hash_secp256k1_and_sr25519_as_the_reference():
    for kinds in (["secp", "secp", "secp"], ["ed", "secp"]):
        ours, theirs, _ = _vals(kinds)
        assert ours.hash() == theirs.hash()
        assert [bytes(v.address) for v in ours.validators] == [
            bytes(v.address) for v in theirs.validators]
    ours, theirs, _ = _vals(["ed", "sr"])
    with pytest.raises(ValueError) as got:
        ours.hash()
    with pytest.raises(ValueError) as want:
        theirs.hash()
    assert str(got.value) == str(want.value)


def test_convert_carries_a_mixed_set():
    ours, theirs, _ = _vals(MIXED12 + ["secp"])
    carried = convert.validator_set_from(theirs)
    assert [(v.pub_key.type, v.pub_key.data, v.voting_power, v.address)
            for v in carried.validators] == [
        (v.pub_key.type, v.pub_key.data, v.voting_power, v.address)
        for v in ours.validators]
    assert [type(v.pub_key) for v in carried.validators] == [
        type(v.pub_key) for v in ours.validators]


def _commits(kinds, tamper=()):
    """(port vals, reference vals, port commit, reference commit) of one
    commit every validator signs; signatures at ``tamper`` flipped."""
    ours_vals, their_vals, signer = _vals(kinds)
    bid = JBlockID(hashlib.sha256(b"mixed block").digest(),
                   JPartSetHeader(1, hashlib.sha256(b"parts").digest()))
    theirs = JCommit(HEIGHT, 0, bid, [
        JCommitSig(J_COMMIT, v.address, 1_700_000_000_000_000_000 + i)
        for i, v in enumerate(their_vals.validators)])
    sigs = []
    for i, cs in enumerate(theirs.signatures):
        sig = signer[bytes(cs.validator_address)](
            theirs.vote_sign_bytes(CHAIN_ID, i))
        sigs.append(_flip(sig) if i in tamper else sig)
    theirs.signatures = [JCommitSig(cs.block_id_flag, cs.validator_address,
                                    cs.timestamp_ns, sig)
                         for cs, sig in zip(theirs.signatures, sigs)]
    return ours_vals, their_vals, convert.commit_from(theirs), theirs


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome is the error's type and words
        return type(e).__name__, str(e)
    return None


def test_verify_commit_on_a_mixed_set_names_the_references_index():
    """A 12-validator mixed commit: valid, then one ed25519 lane and one
    sr25519 lane tampered. The port's batch runs on the device (12 lanes,
    at or above the seed cut), the reference's on its host tier."""
    types = [v.pub_key.type for v in _vals(MIXED12)[0].validators]
    assert set(types[:4]) == {"ed25519", "sr25519"}  # interleaved
    for tamper in ((), ("ed25519",), ("sr25519",)):
        idx = {types.index(k, 3) for k in tamper}
        ours_vals, their_vals, ours, theirs = _commits(MIXED12, idx)
        got = _outcome(lambda: tvalidation.verify_commit(
            CHAIN_ID, ours_vals, ours.block_id, HEIGHT, ours, device="cpu"))
        want = _outcome(lambda: jvalidation.verify_commit(
            CHAIN_ID, their_vals, theirs.block_id, HEIGHT, theirs))
        assert got == want
        if idx:
            assert got[1].startswith(f"wrong signature (#{min(idx)}): ")
        else:
            assert got is None


def _round_votes(their_vals, signer, tampered=()):
    bid = JBlockID(hashlib.sha256(b"vote block").digest(),
                   JPartSetHeader(1, hashlib.sha256(b"vote parts").digest()))
    votes = []
    for i, v in enumerate(their_vals.validators):
        vote = JVote(jcanonical.PRECOMMIT_TYPE, HEIGHT, 0, bid,
                     1_700_000_000_000_000_000 + 7 * i, v.address, i)
        sig = signer[bytes(v.address)](vote.sign_bytes(CHAIN_ID))
        vote.signature = _flip(sig) if i in tampered else sig
        votes.append(vote)
    return votes


def _decisions(vs, votes):
    added, errs = vs.add_votes_batch(votes)
    return [(bool(a), type(e).__name__ if e else None, str(e) if e else None)
            for a, e in zip(added, errs)]


def test_mixed_add_votes_batch_decides_as_the_reference(monkeypatch):
    ours_vals, their_vals, signer = _vals(MIXED12)
    types = [v.pub_key.type for v in ours_vals.validators]
    tampered = {types.index("ed25519"), types.index("sr25519", 4)}
    votes = _round_votes(their_vals, signer, tampered)
    made = []
    real = tbatch.MixedBatchVerifier
    monkeypatch.setattr(tbatch, "MixedBatchVerifier",
                        lambda **kw: made.append(kw) or real(**kw))
    ours = VoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE,
                   ours_vals, device="cpu")
    theirs = JVoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE,
                      their_vals)
    got = _decisions(ours, [convert.vote_from(v) for v in votes])
    assert got == _decisions(theirs, votes)
    assert [i for i, d in enumerate(got) if d[1]] == sorted(tampered)
    assert made == [{"device": "cpu", "pubkey_cache": None, "flavor": None}]
    assert ours.has_two_thirds_majority() == theirs.has_two_thirds_majority()


def test_secp256k1_set_verifies_one_vote_at_a_time(monkeypatch):
    """The port's decisions are pinned on their own; where the
    ``cryptography`` wheel is installed (the reference's secp256k1 keys
    need it) they are also held equal to the reference's."""
    ours_vals, their_vals, signer = _vals(["secp"] * 4)
    calls = []
    real = tsecp.verify
    monkeypatch.setattr(tsecp, "verify",
                        lambda *a: calls.append(a[0]) or real(*a))
    votes = _round_votes(their_vals, signer, tampered={2})
    ours = VoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE,
                   ours_vals, device="cpu")
    got = _decisions(ours, [convert.vote_from(v) for v in votes])
    assert [d[:2] for d in got] == [(True, None), (True, None),
                                    (False, "VoteError"), (True, None)]
    assert len(calls) == 4  # one verify a vote, no batch
    if HAVE_CRYPTOGRAPHY:
        theirs = JVoteSet(CHAIN_ID, HEIGHT, 0, jcanonical.PRECOMMIT_TYPE,
                          their_vals)
        assert got == _decisions(theirs, votes)
    calls.clear()
    ours_vals, their_vals, ours_c, theirs_c = _commits(["secp"] * 4,
                                                       tamper={1})
    got = _outcome(lambda: tvalidation.verify_commit(
        CHAIN_ID, ours_vals, ours_c.block_id, HEIGHT, ours_c, device="cpu"))
    assert got == ("VerificationError", "wrong signature (#1)")
    assert len(calls) == 2  # the walk stops at the first invalid one
    if HAVE_CRYPTOGRAPHY:
        assert got == _outcome(lambda: jvalidation.verify_commit(
            CHAIN_ID, their_vals, theirs_c.block_id, HEIGHT, theirs_c))


def test_sr25519_vote_verifies_inline_beside_a_coalescer(monkeypatch):
    """sr25519 keys stay off the verify coalescer (its wire is ed25519's):
    Vote.verify checks them inline through host_batch.verify_quads."""
    ours_vals, their_vals, signer = _vals(["sr", "sr"])
    votes = [convert.vote_from(v) for v in _round_votes(
        their_vals, signer, tampered={1})]
    calls = []
    real = thost.verify_quads
    monkeypatch.setattr(thost, "verify_quads",
                        lambda q: calls.append(len(q)) or real(q))
    co = coalesce.VerifyCoalescer(device="cpu", min_device_lanes=1)
    co.start()
    coalesce.push_active(co)
    try:
        keys = [v.pub_key for v in ours_vals.validators]
        assert not coalesce.eligible(keys[0])
        votes[0].verify(CHAIN_ID, keys[0])
        with pytest.raises(VoteError, match="invalid signature"):
            votes[1].verify(CHAIN_ID, keys[1])
    finally:
        coalesce.pop_active(co)
        co.stop()
    assert calls == [1, 1] and co.windows == 0


def test_prestage_validators_skips_sr25519_keys(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", "1")
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
    ours_vals, _, _ = _vals(["ed", "sr", "ed", "sr", "sr"])
    assert tbatch.prestage_validators(ours_vals, device="cpu") == 1
    cache = tverify.pubkey_cache("cpu")
    assert set(cache._slots) == {v.pub_key.data for v in ours_vals.validators
                                 if v.pub_key.type == "ed25519"}
