"""The port's commit-verification slice vs the JAX package, on the CPU.

A 16-validator ed25519 set with equal power, keys made from a seed, signs
one precommit Commit. The same keys and commit go through
cometbft_tpu.types.validation and cometbft_tpu_torch.types.validation
(device="cpu": the kernels' plain versions): canonical sign bytes must be
byte-identical, both must accept the good commit, and with one tampered
signature both must raise naming the same index. State carried across
with convert.py (the JAX pubkey arena, the validator set) must verify the
same way.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanonical
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types import validator_set as jvs
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as tref
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import canonical as tcanonical
from cometbft_tpu_torch.types import validation as tvalidation
from cometbft_tpu_torch.types import validator_set as tvs

CHAIN_ID = "port-slice-chain"
HEIGHT = 7
N_VALS = 16
TAMPERED = 9


@pytest.fixture(autouse=True)
def _device_route(monkeypatch):
    """These commits are smaller than the port's host/device cut, which
    would send them to the host tier (held in test_torch_host_batch.py and
    test_torch_coalesce.py): pin the cut to 2 so they take the device
    route, the kernels' plain versions, that this file holds."""
    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _commit(mod, vals, block_id, seeds_by_addr, times, tamper=None):
    sigs = []
    for i, v in enumerate(vals.validators):
        cs = mod.CommitSig(
            block_id_flag=mod.BLOCK_ID_FLAG_COMMIT,
            validator_address=v.address,
            timestamp_ns=times[i],
        )
        sigs.append(cs)
    commit = mod.Commit(height=HEIGHT, round=1, block_id=block_id,
                        signatures=sigs)
    for i, cs in enumerate(sigs):
        seed = seeds_by_addr[bytes(cs.validator_address)]
        sig = tref.sign(seed, commit.vote_sign_bytes(CHAIN_ID, i))
        if i == tamper:
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        sigs[i] = mod.CommitSig(
            block_id_flag=cs.block_id_flag,
            validator_address=cs.validator_address,
            timestamp_ns=cs.timestamp_ns,
            signature=sig,
        )
    return commit


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1016)
    seeds = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(N_VALS)]
    pubs = [tref.pubkey_from_seed(s) for s in seeds]
    j_vals = jvs.ValidatorSet(
        [jvs.Validator(jkeys.Ed25519PubKey(p), 10) for p in pubs]
    )
    t_vals = tvs.ValidatorSet(
        [tvs.Validator(tkeys.Ed25519PubKey(p), 10) for p in pubs]
    )
    seeds_by_addr = {
        bytes(tkeys.Ed25519PubKey(p).address()): s for p, s in zip(pubs, seeds)
    }
    times = [1_700_000_000_000_000_000 + 1_000_003 * i for i in range(N_VALS)]
    bid = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    psh = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    j_bid = jblock.BlockID(bid, jblock.PartSetHeader(3, psh))
    t_bid = tblock.BlockID(bid, tblock.PartSetHeader(3, psh))
    out = {"j_vals": j_vals, "t_vals": t_vals, "j_bid": j_bid, "t_bid": t_bid}
    for tag, tamper in (("good", None), ("bad", TAMPERED)):
        out["j_" + tag] = _commit(jblock, j_vals, j_bid, seeds_by_addr,
                                  times, tamper)
        out["t_" + tag] = _commit(tblock, t_vals, t_bid, seeds_by_addr,
                                  times, tamper)
    return out


def test_validator_sets_and_sign_bytes_identical(world):
    j_vals, t_vals = world["j_vals"], world["t_vals"]
    assert [v.address for v in t_vals.validators] == [
        v.address for v in j_vals.validators
    ]
    assert t_vals.hash() == j_vals.hash()
    assert t_vals.get_proposer().address == j_vals.get_proposer().address
    jc, tc = world["j_good"], world["t_good"]
    for i in range(N_VALS):
        assert tc.vote_sign_bytes(CHAIN_ID, i) == jc.vote_sign_bytes(
            CHAIN_ID, i
        )
        assert tc.signatures[i].signature == jc.signatures[i].signature
    assert tc.hash() == jc.hash()
    assert world["t_bid"].encode() == world["j_bid"].encode()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 6, 7, 9, 13, 100])
def test_merkle_root_matches_reference(n):
    """Odd tails and non-powers of two: the level walk gives the
    reference's split-point root."""
    items = [bytes([i % 256]) * (i % 7) for i in range(n)]
    assert tmerkle.hash_from_byte_slices(items) == (
        jmerkle.hash_from_byte_slices(items)
    )


@pytest.mark.parametrize("msg_type", [1, 2])
@pytest.mark.parametrize("nil_block", [False, True])
def test_canonical_vote_sign_bytes_identical(world, msg_type, nil_block):
    """Prevotes and precommits, for a block and for nil, across
    timestamps (the encoded template is shared by one round context)."""
    j_bid = jblock.BlockID() if nil_block else world["j_bid"]
    t_bid = tblock.BlockID() if nil_block else world["t_bid"]
    for ts in (jblock.proto.ZERO_TIME_NS, 0, 1, 1_700_000_000_123_456_789):
        for height, round_ in ((HEIGHT, 0), (HEIGHT, 3), (2**40, 1)):
            assert tcanonical.vote_sign_bytes(
                CHAIN_ID, msg_type, height, round_, t_bid, ts
            ) == jcanonical.vote_sign_bytes(
                CHAIN_ID, msg_type, height, round_, j_bid, ts
            )


@pytest.mark.parametrize("fn", ["verify_commit", "verify_commit_light"])
def test_good_commit_accepted_by_both(world, fn, monkeypatch):
    """Uncached (COMETBFT_TPU_PUBKEY_CACHE=0, no cache given) and through
    a cache of the caller's."""
    getattr(jvalidation, fn)(
        CHAIN_ID, world["j_vals"], world["j_bid"], HEIGHT, world["j_good"]
    )
    monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE", "0")
    cache = tverify.PubkeyTableCache(device="cpu", capacity=32)
    for pubkey_cache in (None, cache):
        getattr(tvalidation, fn)(
            CHAIN_ID, world["t_vals"], world["t_bid"], HEIGHT,
            world["t_good"], device="cpu", pubkey_cache=pubkey_cache,
        )
    assert cache.builds == 1


@pytest.mark.parametrize("fn", ["verify_commit", "verify_commit_light"])
def test_tampered_commit_rejected_with_same_index(world, fn):
    with pytest.raises(jvalidation.VerificationError) as j_err:
        getattr(jvalidation, fn)(
            CHAIN_ID, world["j_vals"], world["j_bid"], HEIGHT, world["j_bad"]
        )
    with pytest.raises(tvalidation.VerificationError) as t_err:
        getattr(tvalidation, fn)(
            CHAIN_ID, world["t_vals"], world["t_bid"], HEIGHT,
            world["t_bad"], device="cpu",
        )
    assert f"(#{TAMPERED})" in str(j_err.value)
    assert str(t_err.value) == str(j_err.value)


def _recording(routes, fn=None):
    """A stand-in for a verify launcher (verify_rsk_async or
    verify_bytes_async) that records its name in ``routes`` and calls
    ``fn``, or without one returns all-valid lanes unrun."""
    def wrap(name):
        def launcher(*args, **kwargs):
            routes.append(name)
            if fn is not None:
                return fn[name](*args, **kwargs)
            n = args[-1] if len(args) in (2, 5) else kwargs["n"]
            return lambda: np.ones(n, bool)
        return launcher
    return wrap


@pytest.mark.parametrize("cache_env", ["1", "0"])
def test_default_commit_route_matches_reference(world, monkeypatch,
                                                cache_env):
    """A default-argument verify_commit after prestage_validators
    (COMETBFT_TPU_PRESTAGE=1) runs the cached kernel's plain version on
    the process-wide arena and builds nothing more; with
    COMETBFT_TPU_PUBKEY_CACHE=0 prestaging does nothing and the uncached
    one runs. The reference's verify_batch takes the same launcher on the
    same commits, its arena counting the same hits, misses and builds
    (its launchers are recorded, not run: they would compile for minutes
    on a CPU), and the verdicts equal the reference's verify_commit:
    the good commit passes, the tampered one names its index."""
    monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", "1")
    monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE", cache_env)
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
    j_cache = jverify.PubkeyTableCache(capacity=32)
    monkeypatch.setattr(jverify, "_PUBKEY_CACHE", j_cache)
    launchers = ("verify_rsk_async", "verify_bytes_async")
    routes = {"port": [], "reference": []}
    run = {name: getattr(tverify, name) for name in launchers}
    for name in launchers:
        monkeypatch.setattr(tverify, name, _recording(routes["port"],
                                                      run)(name))
        monkeypatch.setattr(jverify, name,
                            _recording(routes["reference"])(name))
    builds = (tbatch.prestage_validators(world["t_vals"], device="cpu"),
              jbatch.prestage_validators(world["j_vals"]))
    assert builds == ((1, 1) if cache_env == "1" else (0, 0))
    for tag in ("good", "bad"):
        commit = world["t_" + tag]
        j_commit = world["j_" + tag]
        errors = []
        for mod, vals, bid, c in (
                (tvalidation, world["t_vals"], world["t_bid"], commit),
                (jvalidation, world["j_vals"], world["j_bid"], j_commit)):
            try:
                kw = {"device": "cpu"} if mod is tvalidation else {}
                mod.verify_commit(CHAIN_ID, vals, bid, HEIGHT, c, **kw)
                errors.append(None)
            except (tvalidation.VerificationError,
                    jvalidation.VerificationError) as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        assert (errors[0] is None) == (tag == "good")
        if tag == "bad":
            assert f"(#{TAMPERED})" in errors[0]
        jverify.verify_batch(
            [v.pub_key.data for v in world["j_vals"].validators],
            [j_commit.vote_sign_bytes(CHAIN_ID, i) for i in range(N_VALS)],
            [cs.signature for cs in j_commit.signatures])
    want = "verify_rsk_async" if cache_env == "1" else "verify_bytes_async"
    assert routes == {"port": [want] * 2, "reference": [want] * 2}
    if cache_env == "1":
        cache = tverify._PUBKEY_CACHE[torch.device("cpu")]
        assert cache is tverify.pubkey_cache("cpu")
        stats = [(c.hits, c.misses, c.builds) for c in (cache, j_cache)]
        assert stats == [(2 * N_VALS, N_VALS, 1)] * 2
    else:
        assert tverify._PUBKEY_CACHE == {}


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_prestaging_skips_the_cpu_unless_forced(world, monkeypatch, mode):
    """COMETBFT_TPU_PRESTAGE=auto warms only a CUDA device and 0 never:
    on the CPU neither builds nor makes the process-wide cache. Forced
    onto a CUDA device this machine lacks, the warm-up raises instead of
    returning 0 as the reference's does."""
    monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", mode)
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
    assert tbatch.prestage_validators(world["t_vals"], device="cpu") == 0
    assert tverify._PUBKEY_CACHE == {}
    if not torch.cuda.is_available():
        monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", "1")
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.prestage_validators(world["t_vals"], device="cuda")


def test_trusting_and_power_errors(world):
    tvalidation.verify_commit_light_trusting(
        CHAIN_ID, world["t_vals"], world["t_good"], device="cpu"
    )
    short = tblock.Commit(
        height=HEIGHT, round=1, block_id=world["t_bid"],
        signatures=[
            cs if i < 10 else tblock.CommitSig.absent()
            for i, cs in enumerate(world["t_good"].signatures)
        ],
    )
    with pytest.raises(tvalidation.NotEnoughVotingPowerError) as err:
        tvalidation.verify_commit(
            CHAIN_ID, world["t_vals"], world["t_bid"], HEIGHT, short,
            device="cpu",
        )
    assert (err.value.got, err.value.needed) == (100, 106)


def test_state_carried_across_with_convert(world):
    """The JAX arena, carried over, gives the JAX verifier's bitmap."""
    pubs = [v.pub_key.data for v in world["j_vals"].validators]
    j_cache = jverify.PubkeyTableCache(capacity=32)
    assert j_cache.lookup(pubs) is not None
    arena = np.asarray(j_cache._arena)
    arena_ok = np.asarray(j_cache._arena_ok)
    cache = convert.pubkey_cache_from_arrays(
        arena, arena_ok, dict(j_cache._slots), device="cpu"
    )
    # the carried tables are the ones the port builds for the same keys
    own = tverify.PubkeyTableCache(device="cpu", capacity=32)
    own_idxs, own_arena, own_ok = own.lookup(pubs)
    idxs, c_arena, c_ok = cache.lookup(pubs)
    assert cache.builds == 0 and cache.hits == N_VALS
    np.testing.assert_array_equal(
        c_arena[..., idxs.astype(np.int64)].numpy(),
        own_arena[..., own_idxs.astype(np.int64)].numpy(),
    )
    np.testing.assert_array_equal(c_ok[idxs.astype(np.int64)].numpy(),
                                  own_ok[own_idxs.astype(np.int64)].numpy())

    t_vals = convert.validator_set_from_pairs(
        [(v.pub_key.data, v.voting_power)
         for v in world["j_vals"].validators]
    )
    assert t_vals.hash() == world["j_vals"].hash()
    tc, jc = world["t_bad"], world["j_bad"]
    jbv, tbv = jbatch.Ed25519BatchVerifier(), tbatch.create_commit_batch_verifier(
        t_vals, device="cpu", pubkey_cache=cache
    )
    for i, (jv, tv) in enumerate(zip(world["j_vals"].validators,
                                     t_vals.validators)):
        jbv.add(jv.pub_key, jc.vote_sign_bytes(CHAIN_ID, i),
                jc.signatures[i].signature)
        tbv.add(tv.pub_key, tc.vote_sign_bytes(CHAIN_ID, i),
                tc.signatures[i].signature)
    j_ok, j_bits = jbv.verify()
    t_ok, t_bits = tbv.verify()
    assert (t_ok, list(t_bits)) == (j_ok, list(j_bits))
    assert t_bits.index(False) == TAMPERED and sum(t_bits) == N_VALS - 1
    assert cache.builds == 0 and cache.hits == 2 * N_VALS
