"""The port's lock tier (libs/sync) and contention profiler
(libs/lockprof), held against the JAX package's.

* ``lockprof.NAMES`` (the ``lock`` label's value space) is the same
  registry, and the port's own locks carry names from it.
* A same-thread re-acquire raises DeadlockError in both.
* The same acquisition sequence gives equal ``observed_lock_order()``
  and equal ``observed_locksets()``; under enforce an edge absent from
  the graph raises LockOrderError in both, and a present one passes.
* The same contended sequence gives equal acquire and contended counts.
* ``held_locks_snapshot`` rows have the same keys.
"""

import threading
import time

import pytest

from cometbft_tpu.libs import lockprof as ref_lockprof
from cometbft_tpu.libs import sync as ref_sync
from cometbft_tpu_torch.libs import lockprof, sync

PAIRS = ((ref_sync, ref_lockprof), (sync, lockprof))


@pytest.fixture
def tiers():
    """Every mode restored after the test."""
    saved = [(s._enabled, s._order_mode, s._order_graph_path,
              s._allowed_edges, s._lockset_mode, lp._enabled, lp._slow_ns)
             for s, lp in PAIRS]
    yield
    for (s, lp), (dl, om, og, ae, lm, le, slow) in zip(PAIRS, saved):
        s._enabled, s._order_mode, s._order_graph_path = dl, om, og
        s._allowed_edges, s._lockset_mode = ae, lm
        lp._enabled, lp._slow_ns = le, slow
        s.reset_lock_order()
        s.reset_locksets()
        lp.reset()


def test_the_registry_is_the_references():
    assert lockprof.NAMES == ref_lockprof.NAMES
    assert lockprof.N_SLOTS == ref_lockprof.N_SLOTS > 60
    assert lockprof.BUCKET_NS == ref_lockprof.BUCKET_NS
    for name in ("crypto.coalesce._mtx", "vote_set", "nope"):
        assert lockprof.slot_for(name) == ref_lockprof.slot_for(name)


def test_the_ports_locks_take_registry_names(tiers):
    """Built while the profiler tier is on (the default), every named lock
    of the planes, the caches and the libs is a profiled lock whose name
    the registry holds."""
    from cometbft_tpu_torch.crypto import batch, coalesce, hashplane
    from cometbft_tpu_torch.crypto import host_batch
    from cometbft_tpu_torch.libs import devstats, log, native_build, trace
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
    from cometbft_tpu_torch.types.vote_set import VoteSet

    co = coalesce.VerifyCoalescer(device="cpu")
    hp = hashplane.HashCoalescer(device="cpu")
    locks = {
        "crypto.coalesce._mtx": co._mtx,
        "crypto.coalesce._rb_mtx": co._rb_mtx,
        "crypto.hashplane._mtx": hp._mtx,
        "crypto.hashplane._rb_mtx": hp._rb_mtx,
        "crypto.hashplane._crossover": hp.crossover._mtx,
        "crypto.batch._crossover": batch.AdaptiveCrossover()._mtx,
        "crypto.host_batch._build_lock": host_batch._load_lock,
        "ops.verify._lane_mtx": ov.LaneArena("cpu")._lock,
        "ops.verify._lock": ov.PubkeyTableCache("cpu", capacity=4)._lock,
        "libs.devstats._mtx": devstats._mtx,
        "libs.trace._mtx": trace._mtx,
        "libs.log": log.Logger()._lock,
        "libs.native_build._lock": native_build._lock,
    }
    for name, lk in locks.items():
        assert isinstance(lk, sync._ProfiledMutex), name
        assert lk._name == name and name in lockprof.NAMES, name
    vals = ValidatorSet([Validator(Ed25519PubKey(b"\x01" * 32), 10)])
    vs = VoteSet("chain", 1, 0, 2, vals)
    assert isinstance(vs._mtx, sync._ProfiledRLock)
    assert vs._mtx._name == "vote_set" and "vote_set" in lockprof.NAMES


def _acquire(lk):  # one acquire site for both packages' witnesses
    lk.acquire()


def test_a_same_thread_reacquire_raises_in_both(tiers):
    for s, _ in PAIRS:
        s.enable()
        mtx = s.Mutex("libs.trace._mtx")
        _acquire(mtx)
        with pytest.raises(s.DeadlockError):
            _acquire(mtx)
        mtx.release()
        rl = s.RLock("vote_set")
        _acquire(rl)
        _acquire(rl)  # reentrant: fine
        rl.release()
        rl.release()
        s.disable()


def _nest(s, names):
    """Acquire ``names`` nested, in order, then release them."""
    locks = [s.Mutex(n) for n in names]
    for lk in locks:
        _acquire(lk)
    for lk in reversed(locks):
        lk.release()


def test_the_same_sequence_records_the_same_order(tiers):
    seqs = [("crypto.coalesce._mtx", "ops.verify._lock"),
            ("vote_set", "crypto.coalesce._mtx"),
            ("libs.trace._mtx", "libs.trace._mtx"),  # same name: skipped
            ("ops.verify._lane_mtx", "not.registered", "vote_set")]
    seen = []
    for s, _ in PAIRS:
        s.set_lock_order_mode("record")
        s.reset_lock_order()
        for names in seqs:
            _nest(s, names)
        seen.append(s.observed_lock_order())
        s.set_lock_order_mode("off")
    assert seen[0] == seen[1]
    assert set(seen[1]) == {
        ("crypto.coalesce._mtx", "ops.verify._lock"),
        ("vote_set", "crypto.coalesce._mtx"),
        ("ops.verify._lane_mtx", "not.registered"),
        ("not.registered", "vote_set"),
    }


def test_enforce_refuses_an_absent_edge_in_both(tiers):
    for s, _ in PAIRS:
        graph = s._static_graph_path()
        s.set_lock_order_mode("enforce", graph)
        edges = s._load_allowed_edges()
        a, b = sorted(edges)[0]
        _nest(s, (a, b))  # in the graph: passes
        outer = s.Mutex("libs.trace._mtx")
        inner = s.Mutex("consensus.state")
        assert ("libs.trace._mtx", "consensus.state") not in edges
        _acquire(outer)
        with pytest.raises(s.LockOrderError):
            _acquire(inner)
        outer.release()
        s.set_lock_order_mode("off", graph)
    assert ref_sync._load_allowed_edges() == sync._load_allowed_edges()


def test_lockset_records_alike(tiers):
    seen = []
    for s, _ in PAIRS:
        s.set_lockset_mode("record")
        s.reset_locksets()
        rl = s.RLock("vote_set")
        rl.acquire()
        s.lockset_note("VoteSet.votes")
        rl.release()
        s.lockset_note("PartSet.count")
        seen.append(s.observed_locksets())
        s.set_lockset_mode("off")
    assert seen[0] == seen[1]
    assert {k for k in seen[1]} == {
        ("VoteSet.votes", frozenset({"vote_set"})),
        ("PartSet.count", frozenset())}


def test_the_port_types_note_their_locksets(tiers):
    """PartSet's store carries the reference's seam."""
    from cometbft_tpu_torch.types import part_set

    sync.set_lockset_mode("record")
    sync.reset_locksets()
    try:
        ps = part_set.PartSet.from_data(b"x" * 100)
        fresh = part_set.PartSet(ps.header)
        fresh.add_part(ps.get_part(0))
        assert ("PartSet.count", frozenset()) in sync.observed_locksets()
    finally:
        sync.set_lockset_mode("off")


def _contend(s, lp):
    """A holder keeps the lock while a second thread blocks on it; then
    an uncontended acquire and a reentrant RLock session."""
    lp.enable()
    lp.reset()
    mtx = s.Mutex("libs.trace._mtx")
    held, go = threading.Event(), threading.Event()

    def holder():
        with mtx:
            held.set()
            go.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    waiter = threading.Thread(target=lambda: (mtx.acquire(),
                                              mtx.release()))
    waiter.start()
    for _ in range(500):  # until the waiter is parked on the lock
        row = s.held_locks_snapshot().get(waiter.ident)
        if row and row["blocked_on"] == "libs.trace._mtx":
            break
        time.sleep(0.01)
    go.set()
    t.join()
    waiter.join()
    with mtx:
        pass
    rl = s.RLock("vote_set")
    with rl:
        with rl:
            pass
    out = {name: {k: v for k, v in lp.counts(lp.slot_for(name)).items()
                  if k in ("acquires", "contended")}
           for name in ("libs.trace._mtx", "vote_set")}
    snap = lp.snapshot()
    lp.disable()
    return out, snap


def test_the_same_contention_counts_alike(tiers):
    (ref_counts, ref_snap), (counts, snap) = (_contend(s, lp)
                                              for s, lp in PAIRS)
    assert counts == ref_counts == {
        "libs.trace._mtx": {"acquires": 3, "contended": 1},
        "vote_set": {"acquires": 1, "contended": 0}}
    assert snap.keys() == ref_snap.keys()
    assert snap["locks"].keys() == ref_snap["locks"].keys()
    assert snap["hottest"] == ref_snap["hottest"] == "libs.trace._mtx"


def test_held_locks_snapshot_has_the_same_keys(tiers):
    rows = []
    for s, _ in PAIRS:
        s.set_lock_order_mode("record")
        lk = s.Mutex("crypto.coalesce._mtx")
        inside, done = threading.Event(), threading.Event()

        def hold(lk=lk, inside=inside, done=done):
            with lk:
                inside.set()
                done.wait(5)

        t = threading.Thread(target=hold)
        t.start()
        inside.wait(5)
        snap = s.held_locks_snapshot()
        done.set()
        t.join()
        s.set_lock_order_mode("off")
        rows.append(snap[t.ident])
    assert rows[0].keys() == rows[1].keys()
    assert rows[0]["held"] == rows[1]["held"] == ["crypto.coalesce._mtx"]


def test_the_kill_switch_hands_out_raw_primitives(tiers, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_LOCKPROF", "0")
    for s, _ in PAIRS:
        assert type(s.Mutex("vote_set")) is type(threading.Lock())
        assert type(s.RLock("vote_set")) is type(threading.RLock())
