"""The port's verify coalescer, host/device cut and batch routing vs the
JAX package, on the CPU.

cometbft_tpu_torch.crypto.coalesce.VerifyCoalescer(device="cpu") runs its
device windows through the kernels' plain versions (K2 on the process-wide
arena of the CPU, K1 with COMETBFT_TPU_PUBKEY_CACHE=0) and its host
windows through the native RLC batch. Each behavior of the reference's
tests/test_coalesce.py that the port keeps is a case here, run with both
tiers pinned in turn (``min_device_lanes`` 1: every window on the device;
a cut no window reaches: every window on the host): flush triggers, a
failing submit, the drain on stop, FIFO readback and the depth bound.
The reference's rescues and breaker are inverted: a kernel that raises at
launch or at readback, or a host engine that raises, fails the window's
tickets and the callers raise, and nothing verifies those lanes again. The
crossover fit answers as the reference's on the same samples, and
Ed25519BatchVerifier takes the reference's route below and above the
cut, with and without a coalescer pushed.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import coalesce as jcoalesce
from cometbft_tpu.crypto import host_batch as jhost
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from cometbft_tpu.crypto.keys import Ed25519PubKey as JPubKey
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import coalesce
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.libs.native_build import NativeBuildError
from cometbft_tpu_torch.ops import verify as tverify

NEVER = 1 << 30  # a device cut no window reaches: the host tier
TIERS = {"device": 1, "host": NEVER}


@pytest.fixture(autouse=True, scope="module")
def _module_state():
    """One torch thread (tiny tensors), and a process-wide CPU arena of
    this module's own, so the device windows of its cases share X1's
    tables."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = tverify._PUBKEY_CACHE
    tverify._PUBKEY_CACHE = {}
    yield
    tverify._PUBKEY_CACHE = saved
    torch.set_num_threads(threads)


def _lanes(n: int, seed: int = 1):
    """(raw pubkeys, msgs, sigs), all valid: keys from the first 8 seeds
    of ``seed``'s family, so device windows reuse arena slots."""
    keys = [JPrivKey.from_seed((seed * 100 + i % 8).to_bytes(32, "big"))
            for i in range(n)]
    msgs = [b"lane-%d-%d" % (seed, i) for i in range(n)]
    return ([k.pub_key().data for k in keys], msgs,
            [k.sign(m) for k, m in zip(keys, msgs)])


def _coalescer(tier="host", **kw):
    kw.setdefault("min_device_lanes", TIERS[tier])
    co = coalesce.VerifyCoalescer(device="cpu", **kw)
    co.start()
    return co


@pytest.fixture
def pushed():
    """Coalescers pushed during a case are popped and stopped after it."""
    made = []

    def push(co):
        made.append(co)
        coalesce.push_active(co)
        return co

    yield push
    for co in made:
        coalesce.pop_active(co)
        if co.is_running():
            co.stop()


# -- flush triggers, failure isolation, drain -------------------------------


@pytest.mark.parametrize("tier", list(TIERS))
def test_size_flush_does_not_wait_for_the_deadline(tier):
    co = _coalescer(tier, window_us=60_000_000, max_lanes=4)
    try:
        pks, msgs, sigs = _lanes(4)
        sigs[1] = sigs[0]  # the wrong message for that key
        bits = co.submit(pks, msgs, sigs).result(timeout=30)
        assert bits == [True, False, True, True]
        assert co.flushes["size"] == 1 and co.windows == 1
        assert co.device_windows == (tier == "device")
    finally:
        co.stop()


@pytest.mark.parametrize("tier", list(TIERS))
def test_deadline_flush_serves_a_lone_lane(tier):
    co = _coalescer(tier, window_us=20_000, max_lanes=1 << 20)
    try:
        pks, msgs, sigs = _lanes(1, seed=2)
        assert co.submit(pks, msgs, sigs).result(timeout=30) == [True]
        assert co.flushes["deadline"] == 1
        assert (co.device_lanes, co.host_lanes) == (
            (1, 0) if tier == "device" else (0, 1))
    finally:
        co.stop()


@pytest.mark.parametrize("tier", list(TIERS))
def test_exception_in_one_submit_fails_only_that_ticket(tier):
    co = _coalescer(tier, window_us=50_000, max_lanes=8)
    try:
        pks, msgs, sigs = _lanes(3, seed=5)
        bad = co.submit([pks[0]], [None], [sigs[0]])  # bytes(None) raises
        good = co.submit(pks[1:3], msgs[1:3], sigs[1:3])
        assert good.result(timeout=30) == [True, True]
        with pytest.raises(TypeError):
            bad.result(timeout=30)
        assert co.windows == 1
    finally:
        co.stop()


@pytest.mark.parametrize("tier", list(TIERS))
def test_drain_delivers_every_pending_ticket(tier):
    """A window and size that never flush on their own: only the drain on
    stop resolves these tickets, through the coalescer's own tier."""
    co = _coalescer(tier, window_us=60_000_000, max_lanes=1 << 20)
    pks, msgs, sigs = _lanes(6, seed=6)
    sigs[2] = bytes(64)
    tickets = [co.submit([pks[i]], [msgs[i]], [sigs[i]]) for i in range(6)]
    assert not any(t.done() for t in tickets)
    co.stop()
    assert all(t.done() for t in tickets)
    assert [t.result(0.1)[0] for t in tickets] == [True] * 2 + [False] + [
        True] * 3
    assert co.flushes["drain"] == 1 and co.device_windows == (
        tier == "device")


def test_stopped_coalescer_raises_and_is_not_routed(pushed):
    co = pushed(_coalescer())
    pks, msgs, sigs = _lanes(1, seed=7)
    co.stop()
    with pytest.raises(coalesce.CoalescerStoppedError):
        co.submit(pks, msgs, sigs)
    with pytest.raises(coalesce.CoalescerStoppedError):
        co.try_verify(pks, msgs, sigs)
    # a stopped coalescer is not routed: the helpers run unrouted
    assert coalesce.active() is None
    assert coalesce.verify_bytes(pks, msgs, sigs) is None
    assert coalesce.verify_signature(Ed25519PubKey(pks[0]), msgs[0], sigs[0])


@pytest.mark.parametrize("tier", list(TIERS))
def test_concurrent_submitters_all_resolve_on_stop(tier):
    co = _coalescer(tier, window_us=60_000_000, max_lanes=1 << 20)
    pks, msgs, sigs = _lanes(8, seed=8)
    results: dict[int, list] = {}

    def submit_and_wait(i):
        results[i] = co.submit([pks[i]], [msgs[i]], [sigs[i]]).result(60)

    threads = [threading.Thread(target=submit_and_wait, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for _ in range(500):
        if co._pending_lanes == 8:
            break
        time.sleep(0.01)
    co.stop()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == {i: [True] for i in range(8)}
    assert co.windows == 1 and co.tickets == 8


# -- device windows --------------------------------------------------------


@pytest.mark.parametrize("cache", ["1", "0"])
def test_device_window_matches_host_verdicts(monkeypatch, cache):
    """One corrupted lane flips only its own bit; the window packs
    natively, stages through the coalescer's lane arena and launches K2's
    plain version on the process-wide arena (K1's with the cache off)."""
    monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE", cache)
    routes = []
    for name in ("verify_rsk_async", "verify_bytes_async"):
        real = getattr(tverify, name)
        monkeypatch.setattr(tverify, name, lambda *a, _n=name, _r=real, **k:
                            routes.append(_n) or _r(*a, **k))
    co = _coalescer("device", window_us=60_000_000, max_lanes=8)
    try:
        pks, msgs, sigs = _lanes(8, seed=4)
        sigs[5] = bytes(64)
        bits = co.submit(pks, msgs, sigs).result(timeout=60)
        assert bits == thost.verify_many(pks, msgs, sigs)
        assert bits == [True] * 5 + [False] + [True] * 2
        assert co.device_windows == 1 and co.host_lanes == 0
        assert routes == ["verify_rsk_async" if cache == "1"
                          else "verify_bytes_async"]
        assert co._lanes.stages == (2 if cache == "1" else 1)
    finally:
        co.stop()


def test_lane_arena_ping_pongs_two_slots_per_bucket():
    arena = tverify.LaneArena("cpu")
    rng = np.random.default_rng(3)
    views = []
    for n in (5, 7, 3, 16):  # buckets 8, 8, 8, 16
        rows = rng.integers(0, 256, (96, n), dtype=np.uint8)
        view = arena.stage("rsk", rows)
        assert view.is_contiguous() and tuple(view.shape) == (96, n)
        np.testing.assert_array_equal(view.numpy(), rows)
        views.append(view)
    # the third bucket-8 window reused the first's slot
    assert views[2].data_ptr() == views[0].data_ptr() != views[1].data_ptr()
    assert arena.allocs == 3 and arena.stages == 4 and arena.buffers() == 3
    idx = np.arange(5, dtype=np.int16)
    np.testing.assert_array_equal(arena.stage("idx", idx).numpy(), idx)
    with pytest.raises(ValueError, match="lane arena lives on"):
        tverify._stage(arena, "rsk", rows, torch.device("meta"))


# -- faults fail the window; nothing verifies again ------------------------


def _raising(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


@pytest.fixture
def no_second_verify(monkeypatch):
    """Every host verifier raises if asked: a fault must not be covered."""
    calls = []

    def guard(*args, **kwargs):
        calls.append(args)
        raise AssertionError("a lane was verified again on the host")

    monkeypatch.setattr(thost, "verify_many", guard)
    monkeypatch.setattr(ref, "verify", guard)
    return calls


@pytest.mark.parametrize("where", ["launch", "readback", "host_engine"])
def test_a_fault_fails_the_window_and_nothing_verifies_again(
        monkeypatch, pushed, where, no_second_verify):
    fault = RuntimeError(f"{where} fault")
    if where == "launch":
        monkeypatch.setattr(tverify, "verify_rsk_async", _raising(fault))
    elif where == "readback":
        monkeypatch.setattr(tverify, "verify_rsk_async",
                            lambda *a, **k: _raising(fault))
    else:
        fault = NativeBuildError("engine fault")
        monkeypatch.setattr(thost, "verify_many", _raising(fault))
    tier = "host" if where == "host_engine" else "device"
    co = pushed(_coalescer(tier, window_us=1_000, max_lanes=4))
    pks, msgs, sigs = _lanes(2, seed=22)
    with pytest.raises(type(fault), match="fault"):
        co.submit(pks, msgs, sigs).result(timeout=30)
    # the routed callers raise too
    with pytest.raises(type(fault), match="fault"):
        coalesce.verify_signature(Ed25519PubKey(pks[0]), msgs[0], sigs[0])
    bv = tbatch.Ed25519BatchVerifier(device="cpu")
    bv.add(Ed25519PubKey(pks[1]), msgs[1], sigs[1])
    with pytest.raises(type(fault), match="fault"):
        bv.verify()
    assert no_second_verify == [] and co.is_running()


def test_a_wedged_window_times_out_and_stop_fails_it(monkeypatch, pushed):
    """A ticket that outlives its wait raises TimeoutError (no breaker, no
    unrouted retry); stop then fails the window the executor never
    finished."""
    release = threading.Event()

    def wedged(self, groups, reason, t_pop):
        release.wait(30)
        raise RuntimeError("released")

    monkeypatch.setattr(coalesce.VerifyCoalescer, "_launch", wedged)
    monkeypatch.setattr(coalesce.VerifyCoalescer, "_JOIN_TIMEOUT_S", 0.2)
    monkeypatch.setattr(coalesce, "_RESULT_TIMEOUT_S", 0.2)
    co = pushed(_coalescer(window_us=1_000, max_lanes=2))
    pks, msgs, sigs = _lanes(2, seed=26)
    with pytest.raises(TimeoutError):
        co.try_verify(pks[:1], msgs[:1], sigs[:1])
    assert coalesce.active() is co  # still routed: nothing tripped
    queued = co.submit(pks[1:], msgs[1:], sigs[1:])
    co.stop()
    with pytest.raises(coalesce.CoalescerStoppedError):
        queued.result(timeout=1)
    release.set()


def test_executor_death_fails_its_tickets(monkeypatch):
    submitted = threading.Event()

    def dying_collect(self):
        submitted.wait(5)
        raise SystemExit("executor killed")  # past `except Exception`

    monkeypatch.setattr(coalesce.VerifyCoalescer, "_collect", dying_collect)
    co = _coalescer()
    try:
        pks, msgs, sigs = _lanes(2, seed=27)
        ticket = co.submit(pks, msgs, sigs)
        submitted.set()
        co._thread.join(timeout=5)
        assert not co._thread.is_alive() and not co.routable()
        with pytest.raises(coalesce.CoalescerStoppedError):
            ticket.result(timeout=1)
    finally:
        submitted.set()
        co.stop()


# -- the readback drain ----------------------------------------------------


def _fake_launch(dispatched, finish_for):
    """A _launch that stages for real and returns an in-flight window
    whose readback is ``finish_for(seq, lanes)``."""
    def launch(self, groups, reason, t_pop):
        pubkeys, _, _, staged = self._stage(groups)
        seq = len(dispatched) + 1
        dispatched.append(seq)
        n = len(pubkeys)
        return coalesce._Inflight(lambda: finish_for(seq, n),
                                  np.ones(n, bool), staged, n, 0.0, reason,
                                  t_pop)
    return launch


def test_tickets_resolve_in_submission_order(monkeypatch):
    """Window 1 reads back slowly, window 2 at once: window 1's tickets
    still resolve first, and window 2 dispatched while window 1 was
    reading back."""
    gate = threading.Event()
    dispatched: list[int] = []
    resolved: list[int] = []

    def finish_for(seq, n):
        if seq == 1:
            gate.wait(10)
        resolved.append(seq)
        return np.ones(n, bool)

    monkeypatch.setattr(coalesce.VerifyCoalescer, "_launch",
                        _fake_launch(dispatched, finish_for))
    co = _coalescer(window_us=1_000, max_lanes=2, max_inflight=2)
    try:
        pks, msgs, sigs = _lanes(4, seed=31)
        t1 = co.submit(pks[:2], msgs[:2], sigs[:2])
        for _ in range(200):
            if dispatched:
                break
            time.sleep(0.01)
        t2 = co.submit(pks[2:], msgs[2:], sigs[2:])
        for _ in range(500):
            if len(dispatched) == 2:
                break
            time.sleep(0.01)
        assert dispatched == [1, 2]
        assert not t1.done() and not t2.done()
        gate.set()
        assert t1.result(timeout=10) == t2.result(timeout=10) == [True] * 2
        assert resolved == [1, 2]
    finally:
        gate.set()
        co.stop()


def test_depth_bound_blocks_the_executor(monkeypatch):
    gate = threading.Event()
    dispatched: list[int] = []

    def finish_for(seq, n):
        gate.wait(10)
        return np.ones(n, bool)

    monkeypatch.setattr(coalesce.VerifyCoalescer, "_launch",
                        _fake_launch(dispatched, finish_for))
    co = _coalescer(window_us=1_000, max_lanes=2, max_inflight=1)
    try:
        pks, msgs, sigs = _lanes(4, seed=33)
        t1 = co.submit(pks[:2], msgs[:2], sigs[:2])
        for _ in range(200):
            if dispatched:
                break
            time.sleep(0.01)
        t2 = co.submit(pks[2:], msgs[2:], sigs[2:])
        time.sleep(0.3)  # time for a wrong executor to overrun the bound
        assert dispatched == [1]
        gate.set()
        assert t1.result(timeout=10) == t2.result(timeout=10) == [True] * 2
        assert dispatched == [1, 2]
    finally:
        gate.set()
        co.stop()


def test_many_threads_share_windows_with_the_same_verdicts(pushed):
    """16 threads of single-signature callers (more than the cores) under
    a short switch interval: every verdict is the host batch's, and
    windows carried lanes from more than one caller."""
    co = pushed(_coalescer(window_us=5_000, max_lanes=64))
    pks, msgs, sigs = _lanes(48, seed=40)
    for i in range(0, 48, 5):
        sigs[i] = sigs[(i + 1) % 48]
    want = thost.verify_many(pks, msgs, sigs)
    got: dict[int, bool] = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def caller(k):
            for i in range(k, 48, 16):
                got[i] = coalesce.verify_signature(Ed25519PubKey(pks[i]),
                                                   msgs[i], sigs[i])
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [got[i] for i in range(48)] == want
    assert co.tickets == 48 and co.windows < co.tickets


# -- the crossover and the cut ---------------------------------------------


def _samples(kind):
    """(host samples, device samples) of (lanes, seconds)."""
    if kind == "floor_over_rate":
        return ([(100, 100 * 100e-6), (400, 400 * 100e-6)],
                [(128, 0.05 + 128 * 2e-6), (1024, 0.05 + 1024 * 2e-6)])
    if kind == "host_overhead_in_floor":
        return ([(n, 1e-3 + n * 100e-6) for n in (1, 2, 4, 8)],
                [(128, 0.05 + 128 * 2e-6), (1024, 0.05 + 1024 * 2e-6)])
    if kind == "host_faster_everywhere":
        return ([(100, 100 * 100e-6), (400, 400 * 100e-6)],
                [(128, 128 * 200e-6), (1024, 1024 * 200e-6)])
    if kind == "clamped_low":
        return [(50, 50e-3), (200, 200e-3)], [(256, 0.001)]
    if kind == "device_profile":  # small windows, a fast device
        return ([(n, 5e-6 + n * 28e-6) for n in (8, 16, 32, 64, 128, 256)],
                [(n, 2e-3 + n * 1e-6) for n in (64, 128, 256, 512, 1024,
                                                2048)])
    return [(100, 0.01)], []  # uncalibrated


@pytest.mark.parametrize("kind", ["floor_over_rate", "host_overhead_in_floor",
                                  "host_faster_everywhere", "clamped_low",
                                  "device_profile", "uncalibrated"])
def test_crossover_fit_matches_reference(kind):
    host, dev = _samples(kind)
    xos = (tbatch.AdaptiveCrossover(), jbatch.AdaptiveCrossover())
    for xo in xos:
        for _ in range(xo.MIN_SAMPLES + 1):
            for n, s in host:
                xo.observe_host(n, s)
            for n, s in dev:
                xo.observe_device(n, s)
    fits = [xo.threshold() for xo in xos]
    assert fits[0] == fits[1]
    assert xos[0].fit_summary() == xos[1].fit_summary()
    if kind == "uncalibrated":
        assert fits[0] is None
    elif kind == "host_faster_everywhere":
        assert fits[0] == tbatch.AdaptiveCrossover.HI
    elif kind == "clamped_low":
        assert fits[0] == tbatch.AdaptiveCrossover.LO
    elif kind == "device_profile":
        assert fits[0] < 256


@pytest.fixture
def fresh_crossovers(monkeypatch):
    monkeypatch.setattr(tbatch, "_CROSSOVERS", {})
    monkeypatch.setattr(tbatch, "_ENV_PINNED", False)
    monkeypatch.setattr(jbatch, "_ENV_PINNED", False)
    monkeypatch.setattr(jbatch, "CROSSOVER", jbatch.AdaptiveCrossover())


def test_host_batch_threshold_seed_calibration_and_pin(monkeypatch,
                                                       fresh_crossovers):
    """Adaptation off: the seed answers. Forced on: windows fed through
    note_host_window/note_device_window calibrate the device's crossover,
    and the cut is the reference's on the same feed. An operator pin
    always wins, and stops the feed."""
    monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", 123)
    monkeypatch.setattr(jbatch, "HOST_BATCH_THRESHOLD", 123)
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0")
    assert tbatch.host_batch_threshold("cpu") == 123
    host, dev = _samples("floor_over_rate")
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "1")
    for _ in range(tbatch.AdaptiveCrossover.MIN_SAMPLES + 1):
        for n, s in host:
            tbatch.note_host_window(n, s, "cpu")
            jbatch.note_host_window(n, s)
        for n, s in dev:
            tbatch.note_device_window(n, s, "cpu")
            jbatch.note_device_window(n, s)
    cut = tbatch.host_batch_threshold("cpu")
    assert cut == jbatch.host_batch_threshold() != 123
    assert tbatch.crossover("cpu") is tbatch.crossover(torch.device("cpu"))
    monkeypatch.setattr(tbatch, "_ENV_PINNED", True)
    assert tbatch.host_batch_threshold("cpu") == 123
    before = tbatch.crossover("cpu")._host_n
    tbatch.note_host_window(10, 1e-3, "cpu")
    assert tbatch.crossover("cpu")._host_n == before
    # the CPU keeps its seed unless adaptation is forced
    monkeypatch.setattr(tbatch, "_ENV_PINNED", False)
    monkeypatch.delenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD")
    assert tbatch.host_batch_threshold("cpu") == 123


@pytest.mark.parametrize("value,want", [("", 64), ("300", 300), ("1", 2),
                                        ("junk", 64)])
def test_host_threshold_seed_reads_only_the_pin(monkeypatch, value, want):
    monkeypatch.setattr(tbatch, "_DEFAULT_HOST_BATCH_THRESHOLD", 64)
    monkeypatch.setenv("COMETBFT_TPU_HOST_THRESHOLD", value)
    assert tbatch._derive_host_threshold() == want


def test_verify_cut_may_settle_below_the_references_floor(monkeypatch,
                                                        fresh_crossovers):
    """The one departure from the reference's fit: a device crossover's
    calibrated verify cut is clamped at 2 lanes, not 64 (on the H100 a K2
    window beats the host batch from 8 lanes). The same samples give the
    reference's 64."""
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "1")
    host, dev = _samples("clamped_low")
    for _ in range(tbatch.AdaptiveCrossover.MIN_SAMPLES + 1):
        for n, s in host:
            tbatch.note_host_window(n, s, "cpu")
            jbatch.note_host_window(n, s)
        for n, s in dev:
            tbatch.note_device_window(n, s, "cpu")
            jbatch.note_device_window(n, s)
    assert tbatch.crossover("cpu").lo == 2
    assert tbatch.host_batch_threshold("cpu") == 2
    assert jbatch.host_batch_threshold() == jbatch.AdaptiveCrossover.LO == 64


def test_windows_feed_the_crossover(monkeypatch, fresh_crossovers):
    """Host and device windows of a CPU coalescer feed the CPU's crossover
    when adaptation is forced, as the reference's windows feed its."""
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "1")
    xo = tbatch.crossover("cpu")
    pks, msgs, sigs = _lanes(3, seed=41)
    for tier in TIERS:
        co = _coalescer(tier, window_us=1_000)
        try:
            assert co.try_verify(pks, msgs, sigs) == [True] * 3
        finally:
            co.stop()
    assert (xo._host_n, xo._dev_n) == (1, 1)


# -- batch routing (the fault: small batches went to the card) ---------------


@pytest.fixture
def routes(monkeypatch):
    """Record which tier each package's batch verifier takes: the host
    batch, the coalescer or the device batch (the reference's device batch
    is recorded, not run: it would compile for minutes on a CPU)."""
    seen = {"port": [], "reference": []}

    def recording(tag, name, real, routed=lambda: True):
        def fn(*args, **kwargs):
            if routed():  # verify_bytes only counts when it routes
                seen[tag].append(name)
            if real is None:
                return True, np.ones(len(args[0]), bool)
            return real(*args, **kwargs)
        return fn

    for tag, hb, co, ov in (("port", thost, coalesce, tverify),
                            ("reference", jhost, jcoalesce, jverify)):
        monkeypatch.setattr(hb, "verify_many",
                            recording(tag, "host", hb.verify_many))
        monkeypatch.setattr(co, "verify_bytes", recording(
            tag, "coalescer", co.verify_bytes,
            lambda co=co: co.active() is not None))
        monkeypatch.setattr(ov, "verify_batch", recording(
            tag, "device", ov.verify_batch if tag == "port" else None))
    for mod in (tbatch, jbatch):
        monkeypatch.setattr(mod, "HOST_BATCH_THRESHOLD", 8)
    monkeypatch.setenv("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "0")
    return seen


@pytest.mark.parametrize("n", [1, 7, 8])
@pytest.mark.parametrize("routed", [False, True])
def test_batch_verifier_routes_as_the_reference(routes, monkeypatch, n,
                                                routed):
    """Below the cut: the pushed coalescer if any, else the host batch; at
    or above it: the device batch. Same choice as the reference's, same
    verdicts (a tampered lane named)."""
    pks, msgs, sigs = _lanes(n, seed=50)
    sigs[n - 1] = bytes(64)
    made = []
    if routed:
        co = _coalescer(window_us=1_000)
        jco = jcoalesce.VerifyCoalescer(device=False, window_us=1_000)
        jco.start()
        made = [(coalesce, co), (jcoalesce, jco)]
        for mod, c in made:
            mod.push_active(c)
    try:
        verdicts = []
        for bv, key in ((tbatch.Ed25519BatchVerifier(device="cpu"),
                         Ed25519PubKey),
                        (jbatch.Ed25519BatchVerifier(), JPubKey)):
            for pk, m, s in zip(pks, msgs, sigs):
                bv.add(key(pk), m, s)
            verdicts.append(bv.verify())
    finally:
        for mod, c in made:
            mod.pop_active(c)
            c.stop()
    if n < 8:
        # a routed batch's window runs the host batch inside the coalescer
        want = ["coalescer", "host"] if routed else ["host"]
        assert routes == {"port": want, "reference": want}
        assert verdicts[0] == verdicts[1]
        assert verdicts[0][1] == [True] * (n - 1) + [False]
    else:
        assert routes == {"port": ["device"], "reference": ["device"]}
        assert verdicts[0][1] == [True] * 7 + [False]
