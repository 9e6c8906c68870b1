"""The port's hash plane vs the JAX package's, on the CPU.

The same inputs, made from seeds, go through cometbft_tpu and
cometbft_tpu_torch (device="cpu": X4's plain version); everything is held
to exact equality:

* the wire: pack_messages' arrays and dtypes at every padding edge and at
  block buckets 1-64;
* the SHA-256 state: sha256_plain against the reference's _sha256_kernel
  (run eagerly under jax.disable_jit: its jitted form compiles for
  minutes on a CPU) and against hashlib, block counts above the bucket
  included;
* merkle roots and proofs, ValueOp / ProofOperators, PartSet headers and
  proofs (also carried across with convert.part_set_from), Data.hash and
  make_block's header hash;
* the coalescer on the CPU: flushes, the split by block bucket, a bad
  lane, device faults that must raise (no hashlib in the device's place),
  the drain on stop, the bound on windows awaiting readback, concurrent
  submitters and PartSet ingress;
* AdaptiveCrossover's thresholds on the same observations, the calibrated
  cut routing a CPU plane under COMETBFT_TPU_ADAPTIVE_THRESHOLD=1, and
  configured_mode on COMETBFT_TPU_HASH.

Where g++ is on the path, X4's CUDA source itself compiles against the
fiber stub of tests/test_torch_fe26.py (every thread of a CTA a fiber:
the schedule warp and the round warp run side by side, handing stages
over at emulated named barriers) and must give hashlib's digests; a
one-character change to a rotation, a ring index or a barrier must not
(a barrier change deadlocks, which the stub reports). It must read no
block past the bucket, whatever a lane's count says, and one warp may
hold lanes of 0, 1, 33, B and more than B blocks side by side.
"""

import ctypes
import hashlib
import random
import re
import sys
import threading

import jax
import numpy as np
import pytest
import test_torch_fe26 as fe26
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import hashplane as jhashplane
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.ops import sha256 as jsha
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import part_set as jpart_set
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import hashplane
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.ops import cuda_sha256
from cometbft_tpu_torch.ops import sha256 as tsha
from cometbft_tpu_torch.ops.build import CSRC
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import part_set as tpart_set

# every SHA-256 padding boundary: the empty message, 55/56 (the last
# length fitting one block, the first needing two), 63/64/65, and
# multi-block interiors
PADDING_EDGES = (0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 127, 128, 129, 200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _msgs(lengths, seed):
    rnd = random.Random(seed)
    return [rnd.randbytes(n) for n in lengths]


def _sha(msgs):
    return [hashlib.sha256(m).digest() for m in msgs]


def _bucket_lengths(bucket, lanes, seed):
    """``lanes`` message lengths whose longest fills block bucket
    ``bucket`` exactly (its last block count), the rest random below."""
    top = 64 * bucket - 9  # the longest message of `bucket` blocks
    rnd = random.Random(seed)
    return [top] + [rnd.randrange(0, top + 1) for _ in range(lanes - 1)]


# ------------------------------------------------------------------ wire


@pytest.mark.parametrize("bucket", [None, 1, 2, 4, 8, 16, 32, 64])
def test_pack_messages_matches_reference(bucket):
    if bucket is None:
        msgs = _msgs(PADDING_EDGES, seed=2)
    else:
        msgs = _msgs(_bucket_lengths(bucket, 11, bucket), seed=bucket)
    tb, tn = tsha.pack_messages(msgs)
    jb, jn = jsha.pack_messages(msgs)
    assert tb.dtype == jb.dtype == np.uint32 and tn.dtype == jn.dtype
    assert tb.shape == jb.shape and tb.shape[0] == (bucket or 4)
    assert np.array_equal(tb, jb) and np.array_equal(tn, jn)
    assert tsha.n_blocks(len(msgs[0])) == jsha.n_blocks(len(msgs[0]))
    assert [tsha.lane_bucket(n) for n in (0, 1, 8, 9, 2049)] == [
        jsha.lane_bucket(n) for n in (0, 1, 8, 9, 2049)]


def test_pack_counts_widen_past_uint16_buckets():
    msgs = [b"abc"]
    tb, tn = tsha.pack_messages(msgs, blocks_cap=1 << 16)
    jb, jn = jsha.pack_messages(msgs, blocks_cap=1 << 16)
    assert tn.dtype == jn.dtype == np.int32
    assert np.array_equal(tn, jn) and np.array_equal(tb[:1], jb[:1])
    assert tsha.pack_messages(msgs, blocks_cap=0xFFFF)[1].dtype == np.uint16
    with pytest.raises(ValueError, match="exceeds bucket"):
        tsha.pack_messages([bytes(64)], blocks_cap=1)


# ----------------------------------------------------------------- state


@pytest.mark.parametrize("bucket", [1, 2])
def test_plain_state_equals_reference_kernel(bucket):
    """16 lanes, 13 with messages: the padding lanes keep H0 in both."""
    msgs = _msgs(_bucket_lengths(bucket, 13, 40 + bucket), seed=bucket)
    blocks, nblocks = jsha.pack_messages(msgs)
    assert blocks.shape == (bucket, 16, 16)
    with jax.disable_jit():
        want = np.asarray(jsha._sha256_kernel(blocks, nblocks))
    got = tsha.sha256_plain(torch.from_numpy(blocks),
                            torch.from_numpy(nblocks))
    assert got.dtype == torch.uint32 and got.shape == (8, 16)
    assert np.array_equal(got.numpy(), want)
    assert tsha._digests_from_state(got.numpy(), 13) == _sha(msgs)


def _over_bucket_wire():
    """A bucket-2 wire of 13 messages in 16 lanes, then block counts that
    overrun it: lane 0 (two blocks) says 3, lane 5 says 4, padding lane 14
    says 3; the rest are as packed."""
    msgs = _msgs(_bucket_lengths(2, 13, 50), seed=5)
    blocks, nblocks = jsha.pack_messages(msgs)
    over = nblocks.copy()
    over[[0, 5, 14]] = (3, 4, 3)
    return blocks, over


def test_counts_above_the_bucket_read_as_the_bucket():
    """The reference scans B blocks whatever a count says; the wrapper's
    CPU path (the plain version) must hash the same, not index past B."""
    blocks, over = _over_bucket_wire()
    with jax.disable_jit():
        want = np.asarray(jsha._sha256_kernel(blocks, over))
    got = cuda_sha256.sha256(torch.from_numpy(blocks),
                             torch.from_numpy(over))
    assert np.array_equal(got.numpy(), want)
    clamped = tsha.sha256_plain(torch.from_numpy(blocks),
                                torch.from_numpy(np.minimum(over, 2)))
    assert np.array_equal(got.numpy(), clamped.numpy())
    real = int(np.minimum(over, 2).sum())  # what the bound counts
    assert cuda_sha256.work(torch.from_numpy(over), 2)[:2] == (
        cuda_sha256.OPS_PER_BLOCK * real,
        cuda_sha256.SHIFT_LOGIC_PER_BLOCK * real)
    widest = over.copy()
    widest[3] = 0xFFFF
    got = cuda_sha256.sha256(torch.from_numpy(blocks),
                             torch.from_numpy(widest))
    with jax.disable_jit():
        assert np.array_equal(
            got.numpy(), np.asarray(jsha._sha256_kernel(blocks, widest)))


def test_plain_digests_equal_hashlib_on_edges_and_fuzz():
    rnd = random.Random(11)
    fuzz = _msgs([rnd.randrange(0, 700) for _ in range(64)], seed=12)
    for msgs in (_msgs(PADDING_EDGES, seed=2), fuzz):
        assert tsha.sha256_many_async(msgs, device="cpu")() == _sha(msgs)
    assert tsha.sha256_many_host(fuzz) == _sha(fuzz)
    assert tsha.sha256_many_async([], device="cpu")() == []
    with pytest.raises(ValueError, match="lane launch cap"):
        tsha.sha256_many_async([b""] * (tsha.MAX_LANES + 1), device="cpu")


# ---------------------------------------------------------------- merkle


def _proof_fields(p):
    return (p.total, p.index, bytes(p.leaf_hash), [bytes(a) for a in p.aunts])


def _items(n, seed):
    rnd = random.Random(seed)
    return [rnd.randbytes(rnd.randrange(40)) for _ in range(n)]


@pytest.mark.parametrize("sizes", [range(0, 68), [10_000]],
                         ids=["0-67", "10000"])
def test_merkle_roots_and_proofs_match_reference(sizes):
    for n in sizes:
        items = _items(n, seed=n)
        root = tmerkle.hash_from_byte_slices(items)
        assert root == jmerkle.hash_from_byte_slices(items), n
        troot, tproofs = tmerkle.proofs_from_byte_slices(items)
        jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
        assert troot == jroot == root, n
        assert [_proof_fields(p) for p in tproofs] == [
            _proof_fields(p) for p in jproofs], n
        for i in {0, n // 2, n - 1} if n else ():
            tproofs[i].verify(root, items[i])
            with pytest.raises(ValueError):
                tproofs[i].verify(root, items[i] + b"x")
            assert tproofs[i].compute_root_hash() == root


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "ok"


def test_value_op_and_proof_operators_accept_and_reject_as_reference():
    values = [b"value-%d" % i for i in range(5)]
    cases = []
    for mod in (jmerkle, tmerkle):
        leaves = [hashlib.sha256(v).digest() for v in values]
        root, proofs = mod.proofs_from_byte_slices(leaves)
        ops = mod.ProofOperators([mod.ValueOp(b"k3", proofs[3])])
        bad_shape = mod.Proof(proofs[3].total, 9, proofs[3].leaf_hash,
                              proofs[3].aunts)
        cases.append([_outcome(fn) for fn in (
            lambda: ops.verify_value(root, [b"k3"], values[3]),
            lambda: ops.verify_value(root, [b"k3"], values[2]),
            lambda: ops.verify_value(root, [b"k2"], values[3]),
            lambda: ops.verify_value(root, [], values[3]),
            lambda: ops.verify_value(root, [b"x", b"k3"], values[3]),
            lambda: ops.verify_value(bytes(32), [b"k3"], values[3]),
            lambda: ops.verify(root, [b"k3"], [values[3], values[3]]),
            lambda: mod.ProofOperators([mod.ValueOp(b"", bad_shape)])
            .verify_value(root, [], values[3]),
        )])
    assert cases[0] == cases[1]
    assert cases[1][0] == "ok" and cases[1].count("ok") == 1


# --------------------------------------------------------- the CPU plane


@pytest.fixture
def plane():
    """A started CPU plane, pushed as the routed one, stopped after."""
    planes = []

    def make(**kw):
        kw.setdefault("min_device_lanes", 2)
        co = hashplane.HashCoalescer(device="cpu", **kw)
        co.start()
        hashplane.push_active(co)
        planes.append(co)
        return co

    yield make
    for co in planes:
        hashplane.pop_active(co)
        if co.is_running():
            co.stop()


def test_part_set_matches_reference_unrouted_and_routed(plane):
    data = random.Random(5).randbytes(10_000)
    jps = jpart_set.PartSet.from_data(data, part_size=1024)
    want = (jps.header.total, jps.header.hash)
    parts = [(p.index, p.bytes_, _proof_fields(p.proof)) for p in jps.parts]
    tps = tpart_set.PartSet.from_data(data, part_size=1024)
    co = plane()
    routed = tpart_set.PartSet.from_data(data, part_size=1024)
    for ps in (tps, routed):
        assert (ps.header.total, ps.header.hash) == want == (10, want[1])
        assert [(p.index, p.bytes_, _proof_fields(p.proof))
                for p in ps.parts] == parts
        assert ps.is_complete() and ps.assemble() == data
    # nine 1,025-byte leaves in bucket 32; the 785-byte tail alone in 16
    assert co.device_windows == 1 and (co.device_lanes, co.host_lanes) == (9, 1)


def test_carried_reference_parts_pass_add_part_and_tampered_raise(plane):
    data = random.Random(6).randbytes(5_000)
    jps = jpart_set.PartSet.from_data(data, part_size=1024)
    co = plane()
    tps = convert.part_set_from(jps)
    assert tps.is_complete() and tps.assemble() == data
    assert tps.parts_bit_array == BitArray.from_indices(5, range(5))
    # four 1,025-byte leaves queued one by one (1-lane windows, below the
    # cut); the 905-byte tail is under the single-message floor
    assert co.tickets == 4 and co.host_lanes == 4
    fresh = tpart_set.PartSet(tps.header)
    part = convert.part_from(jps.parts[2])
    assert fresh.add_part(part) and not fresh.add_part(part)
    bad = convert.part_from(jps.parts[3])
    bad.bytes_ = bad.bytes_[:7] + bytes([bad.bytes_[7] ^ 1]) + bad.bytes_[8:]
    with pytest.raises(tpart_set.PartSetError, match="leaf hash mismatch"):
        fresh.add_part(bad)
    moved = convert.part_from(jps.parts[4])
    moved.proof.index = 1
    with pytest.raises(tpart_set.PartSetError, match="index/total"):
        fresh.add_part(moved)
    assert fresh.count == 1 and not fresh.is_complete()
    with pytest.raises(tpart_set.PartSetError, match="incomplete"):
        fresh.assemble()


def _header_fields(mod):
    sha = [hashlib.sha256(b"field %d" % i).digest() for i in range(6)]
    return dict(
        version=mod.Version(11, 1), chain_id="port-hash-chain",
        time_ns=1_760_000_000 * 10**9,
        last_block_id=mod.BlockID(sha[0], mod.PartSetHeader(3, sha[1])),
        validators_hash=sha[2], next_validators_hash=sha[2],
        consensus_hash=sha[3], app_hash=sha[4], last_results_hash=sha[5],
        proposer_address=bytes(range(20)),
    )


def test_data_hash_and_make_block_match_reference(plane):
    txs = _msgs([random.Random(7).randrange(1, 300) for _ in range(70)],
                seed=8)
    want_data = jblock.Data(txs=txs).hash()
    jb = jblock.make_block(1, txs, None, [], _header_fields(jblock))
    tb = tblock.make_block(1, txs, None, [], _header_fields(tblock))
    assert tblock.Data(txs=txs).hash() == want_data == tb.header.data_hash
    assert tb.header.evidence_hash == jb.header.evidence_hash
    assert tb.header.last_commit_hash == jb.header.last_commit_hash
    assert tb.hash() == jb.hash() is not None
    tb.validate_basic()
    co = plane()
    routed = tblock.make_block(1, txs, None, [], _header_fields(tblock))
    assert routed.hash() == jb.hash() and routed.data.hash() == want_data
    assert co.device_windows >= 1 and co.inline_lanes > 0
    carried = convert.block_from(jb)
    assert carried.hash() == jb.hash()
    carried.validate_basic()
    carried.data.txs[0] = b"tampered"
    with pytest.raises(ValueError, match="data hash"):
        carried.validate_basic()
    assert tblock.BlockID(jb.hash(), tblock.PartSetHeader(1, bytes(32))
                          ).is_complete()
    assert tblock.BlockID(jb.hash()).key() == jblock.BlockID(jb.hash()).key()


def test_routed_digests_equal_hashlib(plane):
    co = plane()
    msgs = _msgs([40] * 40 + [100] * 40, seed=9)  # buckets 1 and 2
    assert hashplane.hash_many(msgs) == _sha(msgs)
    big = b"z" * 4096
    assert hashplane.hash_bytes(big) == hashlib.sha256(big).digest()
    small = b"s" * 100  # below the single-message floor: no ticket
    assert hashplane.hash_bytes(small) == hashlib.sha256(small).digest()
    assert co.tickets == 2 and co.device_windows == 1
    assert co.host_lanes == 1  # the lone 4 KiB lane, below its cut of 2
    assert hashplane.prewarm() and co.device_windows == 2


def test_size_and_deadline_flushes(plane):
    co = plane(window_us=60_000_000, max_lanes=4)
    msgs = _msgs((10, 20, 30, 40), seed=31)
    assert co.submit(msgs).result(timeout=10) == _sha(msgs)
    assert co.flushes["size"] == 1
    co = plane(window_us=20_000, max_lanes=1 << 20)
    assert co.submit([b"lone"]).result(timeout=10) == _sha([b"lone"])
    assert co.flushes["deadline"] == 1 and co.windows == 1


def test_mixed_window_splits_by_block_bucket(plane, monkeypatch):
    calls = []
    real = tsha.sha256_many_async

    def recording(msgs, blocks_cap=None, device="cuda"):
        calls.append((len(msgs), blocks_cap, str(device)))
        return real(msgs, blocks_cap, device)

    monkeypatch.setattr(tsha, "sha256_many_async", recording)
    co = plane(window_us=60_000_000, max_lanes=8)
    msgs = _msgs((0, 55, 56, 64, 65, 1000, 130, 7), seed=32)
    assert co.submit(msgs).result(timeout=30) == _sha(msgs)
    # buckets 1 and 2 carry three lanes each; 4 and 16 one, below the cut
    assert sorted(calls) == [(3, 1, "cpu"), (3, 2, "cpu")]
    assert co.windows == co.device_windows == 1
    assert (co.device_lanes, co.host_lanes) == (6, 2)


def test_bad_lane_fails_only_its_ticket(plane):
    co = plane(window_us=20_000, max_lanes=8)
    bad = co.submit([None])
    good = co.submit([b"x", b"y"])
    assert good.result(timeout=10) == _sha([b"x", b"y"])
    with pytest.raises(TypeError):
        bad.result(timeout=10)


@pytest.mark.parametrize("where", ["dispatch", "materialize"])
def test_device_fault_raises_to_the_caller(plane, monkeypatch, where):
    def dispatch_fault(msgs, blocks_cap=None, device="cuda"):
        raise RuntimeError("device fault at dispatch")

    def materialize_fault(msgs, blocks_cap=None, device="cuda"):
        def finish():
            raise RuntimeError("device fault at materialize")
        return finish

    monkeypatch.setattr(tsha, "sha256_many_async",
                        dispatch_fault if where == "dispatch"
                        else materialize_fault)
    co = plane(min_device_lanes=1)
    msgs = _msgs([40] * 70, seed=33)
    with pytest.raises(RuntimeError, match=f"device fault at {where}"):
        hashplane.hash_many(msgs)
    with pytest.raises(RuntimeError, match=f"device fault at {where}"):
        hashplane.hash_bytes(b"q" * 2048)
    assert co.is_running() and co.windows == 2 and co.host_lanes == 0


def test_stop_drains_pending_and_submit_after_stop_raises(plane,
                                                          monkeypatch):
    # neither size nor deadline can flush these: only the drain
    monkeypatch.setattr(hashplane, "_HOST_S_PER_BLOCK", 1000.0)
    co = plane(window_us=60_000_000, max_lanes=1 << 20)
    msgs = _msgs((5, 10, 15, 20, 25, 300), seed=41)
    tickets = [co.submit([m]) for m in msgs]
    assert not any(t.done() for t in tickets)
    co.stop()
    assert all(t.done() for t in tickets)
    assert [t.result(timeout=0.1)[0] for t in tickets] == _sha(msgs)
    assert co.flushes["drain"] == 1 and co.device_windows == 1
    with pytest.raises(hashplane.HashplaneStoppedError):
        co.submit([b"x"])
    assert hashplane.active() is None  # a stopped plane routes nothing


def test_concurrent_submitters_all_resolve(plane):
    co = plane(window_us=2_000, max_lanes=64)
    per_thread = 6
    results: dict[int, list] = {}
    errors = []

    def work(i):
        try:
            msgs = _msgs([30 + i] * (3 + i), seed=100 + i)
            got = [co.submit(msgs).result(timeout=30)
                   for _ in range(per_thread)]
            results[i] = got == [_sha(msgs)] * per_thread
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == dict.fromkeys(range(8), True)
    assert co.tickets == 8 * per_thread
    assert co.windows < co.tickets  # some windows were shared


def test_part_ingress_from_eight_threads_shares_windows(plane):
    data = random.Random(10).randbytes(24 * 1024)
    ref = tpart_set.PartSet.from_data(data, part_size=1024)
    co = plane(window_us=5_000)
    fresh = tpart_set.PartSet(ref.header)
    errors = []

    def feed(k):
        try:
            for i in range(k, ref.header.total, 8):
                assert fresh.add_part(ref.get_part(i))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=feed, args=(k,), daemon=True)
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert fresh.assemble() == data and fresh.count == 24
    assert co.tickets == 24 and co.device_windows >= 1


@pytest.mark.parametrize("depth", [1, 2])
def test_max_inflight_bounds_windows_awaiting_readback(plane, monkeypatch,
                                                       depth):
    """With readback held, the executor dispatches ``max_inflight``
    windows and then waits; released, every window resolves."""
    gate = threading.Event()
    launched = []
    real = tsha.sha256_many_async

    def gated(msgs, blocks_cap=None, device="cuda"):
        finish = real(msgs, blocks_cap, device)
        launched.append(len(msgs))

        def held():
            assert gate.wait(30)
            return finish()
        return held

    monkeypatch.setattr(tsha, "sha256_many_async", gated)
    co = plane(window_us=1_000, max_lanes=2, max_inflight=depth)
    batches = [_msgs([40, 41], seed=60 + i) for i in range(4)]
    tickets = [co.submit(m) for m in batches]
    try:
        for _ in range(300):
            if len(launched) >= depth:
                break
            threading.Event().wait(0.01)
        threading.Event().wait(0.3)  # time to overrun the bound, if it could
        assert len(launched) == depth and not any(t.done() for t in tickets)
    finally:
        gate.set()
    assert [t.result(timeout=30) for t in tickets] == [_sha(m)
                                                       for m in batches]
    assert launched == [2] * 4 and co.device_windows == 4


# reference observations: (side, lanes, seconds) from a seeded profile
def _crossover_feed(profile, seed):
    rnd = random.Random(seed)
    (h_floor, h_rate), (d_floor, d_slope) = profile
    feed = []
    for _ in range(12):
        n = rnd.choice((8, 16, 64, 256, 1024, 4096))
        noise = 1 + rnd.uniform(-0.05, 0.05)
        feed.append(("host", n, (h_floor + h_rate * n) * noise))
        n = rnd.choice((16, 64, 2048))
        feed.append(("device", n, (d_floor + d_slope * n) * noise))
    # ignored by both: no lanes, no time
    feed += [("host", 0, 1.0), ("device", 64, 0.0), ("device", -3, 1.0)]
    return feed


CROSSOVER_PROFILES = {
    # ((host floor s, host s a lane), (device floor s, device s a lane))
    "device from the smallest": ((1e-3, 1e-6), (1e-4, 1e-8)),
    "crossover in range": ((1e-5, 2e-6), (2e-3, 1e-7)),
    "host always": ((1e-5, 1e-7), (2e-3, 1e-6)),
    "one size a side": ((1e-5, 0.0), (2e-3, 0.0)),
}


@pytest.mark.parametrize("profile", list(CROSSOVER_PROFILES))
def test_adaptive_crossover_matches_reference(profile):
    """The same observations give the same threshold after each one:
    None until both sides have MIN_SAMPLES, then the solved cut clamped
    to [LO, HI]."""
    ref, port = jbatch.AdaptiveCrossover(), tbatch.AdaptiveCrossover()
    seen = []
    for side, n, seconds in _crossover_feed(CROSSOVER_PROFILES[profile],
                                            seed=len(profile)):
        for xo in (ref, port):
            getattr(xo, f"observe_{side}")(n, seconds)
        assert port.threshold() == ref.threshold()
        seen.append(port.threshold())
    assert seen[0] is None and seen[-1] is not None
    final = seen[-1]
    lo, hi = tbatch.AdaptiveCrossover.LO, tbatch.AdaptiveCrossover.HI
    expect = {"device from the smallest": final == lo,
              "crossover in range": lo < final < hi,
              "host always": final == hi,
              "one size a side": final == hi}
    assert expect[profile], final


@pytest.mark.parametrize("mode,device,adapts", [
    ("auto", "cpu", False), ("auto", "cuda", True), ("1", "cpu", True),
    ("0", "cuda", False)])
def test_adaptation_is_keyed_on_the_device(monkeypatch, mode, device,
                                           adapts):
    if mode == "auto":
        monkeypatch.delenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", mode)
    assert tbatch._adaptive_enabled(device) is adapts


@pytest.fixture
def fresh_crossovers(monkeypatch):
    """Both packages' process-wide crossovers start uncalibrated, and the
    port's is forgotten again after the test."""
    hashplane.reset_crossovers()
    monkeypatch.setattr(jhashplane, "CROSSOVER",
                        jhashplane._BucketCrossover())
    yield
    hashplane.reset_crossovers()


@pytest.mark.parametrize("mode", ["1", "auto"])
def test_calibrated_cut_routes_the_cpu_plane(plane, monkeypatch, mode,
                                             fresh_crossovers):
    """Forced on, the plane's bucket-1 fit answers 64 lanes (the device
    wins from the smallest routed size) and a 64-lane window goes to the
    device, a 63-lane one to the host; the windows feed the fit. Off (the
    CPU's default), the seed cut of 2,048 keeps both on the host."""
    if mode == "auto":
        monkeypatch.delenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", mode)
    co = plane(min_device_lanes=None, window_us=60_000_000, max_lanes=64)
    for n in (8, 16, 32, 64, 128):
        co.crossover.note_host(1, n, 1.0 + 1e-3 * n)
        co.crossover.note_device(1, n, 1e-4)
    forced = mode == "1"
    msgs = _msgs([40] * 64, seed=70)
    assert co.crossover.threshold(1) == (64 if forced else 2048)
    assert co.submit(msgs).result(timeout=30) == _sha(msgs)
    assert co.crossover.threshold(1) == (64 if forced else 2048)
    assert co.submit(msgs[:63]).result(timeout=30) == _sha(msgs[:63])
    assert co.windows == 2
    assert (co.device_lanes, co.host_lanes) == ((64, 63) if forced
                                                else (0, 127))
    fit = co.crossover._fit(1)
    assert (fit._host_n, fit._dev_n) == ((6, 6) if forced else (0, 0))


def test_second_plane_starts_from_the_first_planes_cut(plane, monkeypatch,
                                                        fresh_crossovers):
    """The cut is process-wide per device, as the reference's CROSSOVER
    is: two planes in turn, the first calibrated on bucket 1 (the same
    observations fed to each package's crossover: a device window of the
    reference would compile its kernel for minutes on a CPU), and the
    second starts from that cut (64 lanes), not from the seed (2,048), in
    both. The port's second plane then routes a 64-lane window to its
    device and a 63-lane one to the host."""
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "1")
    cuts = {}
    for turn in ("first", "second"):
        co = plane(min_device_lanes=None, window_us=60_000_000, max_lanes=64)
        ref = jhashplane.HashCoalescer(device=False)
        ref.start()
        try:
            cuts[turn] = (co._device_cut(1), ref._device_cut(1))
            if turn == "first":
                for n in (8, 16, 32, 64, 128):
                    for xo in (co.crossover, jhashplane.CROSSOVER):
                        xo.note_host(1, n, 1.0 + 1e-3 * n)
                        xo.note_device(1, n, 1e-4)
                cuts["calibrated"] = (co._device_cut(1), ref._device_cut(1))
            else:
                msgs = _msgs([40] * 64, seed=71)
                assert co.submit(msgs).result(timeout=30) == _sha(msgs)
                assert co.submit(msgs[:63]).result(timeout=30) == _sha(
                    msgs[:63])
                assert (co.device_lanes, co.host_lanes) == (64, 63)
        finally:
            ref.stop()
            hashplane.pop_active(co)
            co.stop()
    assert cuts == {"first": (2048, 2048), "calibrated": (64, 64),
                    "second": (64, 64)}
    assert hashplane.crossover("cpu") is co.crossover


@pytest.mark.parametrize("value", [None, "1", "on", "TRUE", "yes", "0",
                                   "off", "False", "no", "auto", "maybe"])
def test_configured_mode_matches_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("COMETBFT_TPU_HASH", raising=False)
    else:
        monkeypatch.setenv("COMETBFT_TPU_HASH", value)
    assert hashplane.configured_mode() == jhashplane.configured_mode()


# ------------------------------------------------- X4's source under g++

def _compile_sha256(tmp, source):
    """sha256.cu as a C++ library on test_torch_fe26's fiber stub: every
    thread of a CTA a fiber, the schedule warp and the round warp side by
    side, yielding at the named barriers (emulated there: a wait yields
    until its phase completes; a launch whose fibers all wait returns an
    error) and at the warp reduction of the largest count."""
    source, n = re.subn(
        r'asm volatile\("bar\.(sync|arrive) %0, %1;"[^;]*;',
        r"::emu::bar_\1(id, threads);", source)
    assert n == 2
    lib = fe26._compile(tmp, "sha256", source)
    lib.sha256_blocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.sha256_blocks.restype = ctypes.c_int
    return lib


def _run_x4(lib, blocks, nblocks, counts_dtype):
    """(the C entry's return, the (8, L) state) of X4 on a packed wire."""
    nb = np.ascontiguousarray(nblocks.astype(counts_dtype))
    lanes = nb.shape[0]
    state = np.full((8, lanes), 0xDEADBEEF, np.uint32)
    rc = lib.sha256_blocks(blocks.ctypes.data, nb.ctypes.data,
                           int(counts_dtype == np.uint16), state.ctypes.data,
                           blocks.shape[0], lanes, None)
    return rc, state


MUTATIONS = {
    "none": None,
    "rotation": ("rotr(e, 6)", "rotr(e, 7)"),
    "ring index": ("w[(t - 7) & 15]", "w[(t - 6) & 15]"),
    # the round warp reads a stage without waiting for it
    "stage wait": ("    bar_sync(FULL + s, THREADS);",
                   "    bar_arrive(FULL + s, THREADS);"),
    # the schedule warp overwrites stages the round warp has not read
    "stage release": ("if (b >= STAGES) bar_sync(", "if (false) bar_sync("),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_x4_source_under_gpp_matches_hashlib(tmp_path, mutation):
    source = (CSRC / "sha256.cu").read_text()
    if MUTATIONS[mutation] is not None:
        old, new = MUTATIONS[mutation]
        assert source.count(old) == 1
        source = source.replace(old, new)
    lib = _compile_sha256(tmp_path, source)
    # the padding edges, then a 3-block and a 9-block message, in one wire
    msgs = _msgs(PADDING_EDGES, seed=2) + _msgs((150, 560), seed=3)
    assert [tsha.n_blocks(len(m)) for m in msgs[-2:]] == [3, 9]
    blocks, nblocks = tsha.pack_messages(msgs)
    for counts in (np.uint16, np.int32):
        rc, state = _run_x4(lib, blocks, nblocks, counts)
        got = tsha._digests_from_state(state, len(msgs))
        if mutation == "none":
            assert rc == 0 and got == _sha(msgs)
            plain = tsha.sha256_plain(
                torch.from_numpy(blocks),
                torch.from_numpy(nblocks.astype(counts)))
            assert np.array_equal(state, plain.numpy())  # padding lanes too
        else:  # wrong digests, or every fiber waiting: a deadlock
            assert rc != 0 or got != _sha(msgs)


def test_x4_source_under_gpp_ragged_counts_in_one_warp(tmp_path):
    """One warp's lanes hold 1, 33, B (64) and more than B (71, read as B)
    blocks, and 0 (a lane with a message, counted out; and the padding
    lanes): every lane walks to the largest count with the others and
    keeps its state past its own. Rows past B are random words, so a
    block read past a count would show."""
    lib = _compile_sha256(tmp_path, (CSRC / "sha256.cu").read_text())
    msgs = _msgs((40, 2048, 4087, 4087, 100), seed=8)
    blocks, nblocks = tsha.pack_messages(msgs)
    assert blocks.shape == (64, 16, 8)
    assert nblocks.tolist() == [1, 33, 64, 64, 2, 0, 0, 0]
    counts = nblocks.copy()
    counts[3], counts[4] = 71, 0
    room = (72, 16, 8)
    buf = np.frombuffer(random.Random(9).randbytes(4 * np.prod(room)),
                        np.uint32).reshape(room).copy()
    buf[:64] = blocks
    for dtype in (np.uint16, np.int32):
        state = np.full((8, 8), 0xDEADBEEF, np.uint32)
        nb = counts.astype(dtype)
        assert lib.sha256_blocks(buf.ctypes.data, nb.ctypes.data,
                                 int(dtype == np.uint16), state.ctypes.data,
                                 64, 8, None) == 0
        got = tsha._digests_from_state(state, 4)
        assert got == _sha(msgs[:4])
        plain = tsha.sha256_plain(torch.from_numpy(blocks),
                                  torch.from_numpy(nb))
        assert np.array_equal(state, plain.numpy())
        iv = plain.numpy()[:, 5]
        assert np.array_equal(state[:, 4], iv)  # counted out: the IV


def test_x4_source_under_gpp_reads_no_block_past_the_bucket(tmp_path):
    """Counts above B: the wire sits in front of random words, so a block
    read past B would change the state; X4 must equal the plain version,
    which reads such a count as B."""
    lib = _compile_sha256(tmp_path, (CSRC / "sha256.cu").read_text())
    blocks, over = _over_bucket_wire()
    bb, _, lanes = blocks.shape
    room = (bb + 4, 16, lanes)  # past B: more blocks than any count asks
    poison = np.frombuffer(random.Random(6).randbytes(4 * np.prod(room)),
                           np.uint32).reshape(room)
    buf = poison.copy()
    buf[:bb] = blocks
    for counts in (np.uint16, np.int32):
        state = np.zeros((8, lanes), np.uint32)
        nb = over.astype(counts)
        assert lib.sha256_blocks(buf.ctypes.data, nb.ctypes.data,
                                 int(counts == np.uint16), state.ctypes.data,
                                 bb, lanes, None) == 0
        plain = tsha.sha256_plain(torch.from_numpy(blocks),
                                  torch.from_numpy(nb))
        assert np.array_equal(state, plain.numpy())
