"""The port's device-time ledger (libs/devledger) and the planes' hooks,
held against the JAX package's.

* The same sequence of record calls into both ledgers, under one fake
  ``time.monotonic_ns``, gives equal snapshots, reconciliations, occupancy
  views, cells and lane splits.
* Caller classes nest alike (the outermost declaration wins), and
  ``sample()`` writes the same exposition lines.
* The port's VerifyCoalescer(device="cpu") and HashCoalescer(device="cpu")
  attribute lanes, tickets, windows and EV_BUDGET/EV_HASH ring rows as
  the reference's planes (device=False) do on the same inputs, and
  reconcile within 1 %; a window above the cut (K2's plain version on
  the CPU) counts one device window; a mixed hash window charges its
  device and its host share apart.
* An expired request deadline: the reference returns None (its caller
  then verifies on the host); the port raises TimeoutError.
"""

import time

import pytest

from cometbft_tpu.crypto import coalesce as ref_coalesce
from cometbft_tpu.crypto import hashplane as ref_hashplane
from cometbft_tpu.crypto.keys import Ed25519PrivKey
from cometbft_tpu.libs import devledger as ref_ledger
from cometbft_tpu.libs import health as ref_health
from cometbft_tpu.libs import metrics as ref_metrics
from cometbft_tpu_torch.crypto import coalesce, hashplane
from cometbft_tpu_torch.libs import devledger, health
from cometbft_tpu_torch.libs import metrics as port_metrics
from cometbft_tpu_torch.ops import verify as ov

V, H = devledger.PLANE_VERIFY, devledger.PLANE_HASH
CID = devledger.CALLER_CODES

# Record sequences: (function, args) into each ledger. exec_begin/exec_end
# and note_readback read the (fake) clock, so the overlap and the busy
# fraction depend on the interleaving as well as the values.
SEQUENCES = {
    "verify_device_and_host": [
        ("exec_begin", (V,)),
        ("note_window", (V, 12, True)),
        ("exec_end", (V,)),
        ("exec_begin", (V,)),  # the next window's pack under readback
        ("readback", (V,)),
        ("note_window_time", (V, 9_000)),
        ("note_resolve", (V, CID["consensus-vote"], 8, 500, 6_000, 0)),
        ("note_resolve", (V, CID["light"], 4, 100, 3_000, 0)),
        ("note_window", (V, 3, False)),
        ("exec_end", (V,)),
        ("note_window_time", (V, 2_000)),
        ("note_resolve", (V, CID["commit-verify"], 3, 50, 0, 2_000)),
    ],
    "hash_mixed_window": [
        ("exec_begin", (H,)),
        ("note_window", (H, 5, True)),
        ("exec_end", (H,)),
        ("readback", (H,)),
        ("note_window_time", (H, 7_001)),
        ("note_resolve", (H, CID["merkle"], 3, 10, 3_000, 1_200)),
        ("note_resolve", (H, CID["mempool"], 2, 20, 2_000, 800)),
        ("note_window", (H, 2, False)),
        ("note_window_time", (H, 999)),
        ("note_resolve", (H, CID["other"], 2, 0, 0, 999)),
    ],
    "readback_after_the_executor_idles": [
        ("note_window", (V, 1, True)),
        ("readback", (V,)),
        ("readback", (V,)),
        ("note_window_time", (V, 40)),
        ("note_resolve", (V, CID["evidence"], 1, 7, 40, 0)),
    ],
}


class _Clock:
    """A monotonic_ns that advances 1,000 ns a read."""

    def __init__(self):
        self.t = 1_000_000

    def __call__(self):
        self.t += 1_000
        return self.t


def _replay(ledger, seq):
    for fn, args in seq:
        if fn == "readback":  # a drain-side readback, as the planes make it
            t0 = time.monotonic_ns()
            busy0 = ledger.exec_busy_ns(args[0])
            ledger.note_readback(args[0], t0, busy0)
        else:
            getattr(ledger, fn)(*args)


def _views(ledger):
    return {
        "snapshot": ledger.snapshot(),
        "reconcile": ledger.reconcile(),
        "occupancy": ledger.occupancy(),
        "split": ledger.verify_lanes_split(),
        "cells": [ledger.cell(p, c) for p in range(ledger.N_PLANES)
                  for c in range(ledger.N_CALLERS)],
    }


@pytest.fixture
def ledgers():
    """Both ledgers on, their columns clean; state restored after."""
    was = (ref_ledger.enabled(), devledger.enabled())
    for lg in (ref_ledger, devledger):
        lg.enable()
        lg.reset()
    yield
    for lg, on in zip((ref_ledger, devledger), was):
        lg.reset()
        lg.enable() if on else lg.disable()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_the_same_records_give_the_same_views(ledgers, monkeypatch, name):
    seq = SEQUENCES[name]
    views = []
    for lg in (ref_ledger, devledger):
        monkeypatch.setattr(time, "monotonic_ns", _Clock())
        _replay(lg, seq)
        views.append(_views(lg))
    assert views[0] == views[1]
    for plane, r in views[1]["reconcile"].items():
        if r["window_ns"]:
            assert r["caller_lanes"] == r["window_lanes"], plane
            assert abs(1 - r["ratio"]) <= 0.01, plane


def test_a_disabled_ledger_records_nothing_in_either(ledgers, monkeypatch):
    views = []
    for lg in (ref_ledger, devledger):
        lg.disable()
        monkeypatch.setattr(time, "monotonic_ns", _Clock())
        _replay(lg, SEQUENCES["verify_device_and_host"])
        views.append(_views(lg))
    assert views[0] == views[1]
    assert views[1]["occupancy"]["verify"]["windows"] == 0


def test_enums_and_caller_nesting_match():
    for name in ("CALLERS", "CALLER_CODES", "PLANES", "BUDGET_VERIFY_CALLERS",
                 "BUDGET_HASH_CALLERS"):
        assert getattr(devledger, name) == getattr(ref_ledger, name), name
    seen = []
    for lg in (ref_ledger, devledger):
        row = [lg.current_caller()]
        with lg.caller_class("light"):
            row.append(lg.current_caller())
            with lg.caller_class("commit-verify"):  # inner: a no-op
                row.append(lg.current_caller())
            row.append(lg.current_caller())
        with lg.caller_class("no-such-tenant"):  # unknown: "other"
            row.append(lg.current_caller())
            with lg.caller_class("merkle"):  # "other" is no declaration
                row.append(lg.current_caller())
        row.append(lg.current_caller())
        row.append([lg.caller_name(c) for c in (-1, 0, 4, 99)])
        seen.append(row)
    assert seen[0] == seen[1]
    assert seen[1][:7] == [0, CID["light"], CID["light"], CID["light"], 0,
                           CID["merkle"], 0]


def _device_lines(registry) -> list[str]:
    return [ln for ln in registry.render().splitlines()
            if ln.startswith(("cometbft_tpu_device_time_seconds_total",
                              "cometbft_tpu_device_lanes_total"))]


def test_sample_writes_the_same_exposition(ledgers, monkeypatch):
    lines = []
    for lg, lib in ((ref_ledger, ref_metrics), (devledger, port_metrics)):
        monkeypatch.setattr(time, "monotonic_ns", _Clock())
        for seq in SEQUENCES.values():
            _replay(lg, seq)
        m = lib.NodeMetrics()
        lg.sample(m)
        lg.sample(m)  # from the watermarks: nothing counted twice
        _replay(lg, SEQUENCES["readback_after_the_executor_idles"])
        lg.sample(m)
        lines.append(_device_lines(m.registry))
    assert lines[0] == lines[1]
    assert ('cometbft_tpu_device_lanes_total{plane="verify",'
            'caller="evidence"} 2.0') in lines[1]


# -- the planes ------------------------------------------------------------


def _ed_lanes(n, seed=b"\x11"):
    k = Ed25519PrivKey.from_seed(seed * 32)
    pub = k.pub_key().data
    msgs = [b"msg-%d" % i for i in range(n)]
    return [pub] * n, msgs, [k.sign(m) for m in msgs]


@pytest.fixture
def rings():
    """Both flight recorders on and empty, both packages reporting to
    fresh NodeMetrics; restored after."""
    was = (ref_health.enabled(), health.enabled())
    ms = (ref_metrics.NodeMetrics(), port_metrics.NodeMetrics())
    ref_metrics.push_node_metrics(ms[0])
    port_metrics.push_node_metrics(ms[1])
    for h in (ref_health, health):
        h.enable(ring=1024)
        h.reset()
    yield ms
    ref_metrics.pop_node_metrics(ms[0])
    port_metrics.pop_node_metrics(ms[1])
    for h, on in zip((ref_health, health), was):
        h.reset()
        h.enable() if on else h.disable()


def _attribution(lg, hl, plane):
    occ = lg.occupancy()[lg.PLANES[plane]]
    rows = hl.recorder().dump()
    return {
        "cells": {name: {k: lg.cell(plane, c)[k] for k in ("lanes",
                                                           "tickets")}
                  for name, c in lg.CALLER_CODES.items()
                  if lg.cell(plane, c)["tickets"]},
        "rows": sorted(lg.snapshot()["callers"][lg.PLANES[plane]]),
        "windows": (occ["windows"], occ["device_windows"],
                    occ["window_lanes"]),
        "budget_rows": [r["plane"] for r in rows
                        if r["event"] == "plane.budget"],
        "hash_rows": [(r["lanes"], r["device"]) for r in rows
                      if r["event"] == "hash.flush"],
    }


def _reconciled(lg, plane):
    r = lg.reconcile()[lg.PLANES[plane]]
    assert r["caller_lanes"] == r["window_lanes"] > 0
    assert abs(1 - r["ratio"]) <= 0.01, r


def test_verify_planes_attribute_alike(ledgers, rings):
    pubs, msgs, sigs = _ed_lanes(6)
    seen = []
    for lg, hl, co in (
        (ref_ledger, ref_health, ref_coalesce.VerifyCoalescer(
            device=False, window_us=200, min_device_lanes=1 << 30)),
        (devledger, health, coalesce.VerifyCoalescer(
            device="cpu", window_us=200, min_device_lanes=1 << 30)),
    ):
        co.start()
        try:
            with lg.caller_class("consensus-vote"):
                assert co.try_verify(pubs[:4], msgs[:4], sigs[:4]) == [
                    True] * 4
            with lg.caller_class("light"):
                assert co.try_verify(pubs[4:], msgs[4:], sigs[4:]) == [
                    True] * 2
            with lg.caller_class("consensus-vote"):  # a bad signature
                assert co.try_verify(pubs[:1], msgs[1:2], sigs[:1]) == [
                    False]
        finally:
            co.stop()
        assert lg.cell(V, CID["consensus-vote"])["host_ns"] > 0
        assert lg.cell(V, CID["consensus-vote"])["exec_ns"] == 0
        _reconciled(lg, V)
        seen.append(_attribution(lg, hl, V))
    assert seen[0] == seen[1]
    assert seen[1]["cells"] == {"consensus-vote": {"lanes": 5, "tickets": 2},
                                "light": {"lanes": 2, "tickets": 1}}
    assert seen[1]["budget_rows"] == ["verify", "verify"]
    m = rings[1]
    assert m.device_queue_wait.labels("verify", "consensus-vote")._n == 2
    assert m.device_queue_wait.labels("verify", "light")._n == 1
    assert m.coalesce_window_lanes._n == 3


def test_hash_planes_attribute_alike(ledgers, rings):
    seen = []
    for lg, hl, co in (
        (ref_ledger, ref_health, ref_hashplane.HashCoalescer(
            device=False, window_us=200)),
        (devledger, health, hashplane.HashCoalescer(
            device="cpu", window_us=200)),
    ):
        co.start()
        try:
            with lg.caller_class("mempool"):
                co.submit([b"a" * 100, b"b" * 3000]).result(5)
            with lg.caller_class("merkle"):
                co.submit([b"c" * 64]).result(5)
            co.submit([b"d"]).result(5)  # undeclared: "other"
        finally:
            co.stop()
        _reconciled(lg, H)
        seen.append(_attribution(lg, hl, H))
    assert seen[0] == seen[1]
    assert seen[1]["cells"] == {"other": {"lanes": 1, "tickets": 1},
                                "mempool": {"lanes": 2, "tickets": 1},
                                "merkle": {"lanes": 1, "tickets": 1}}
    assert seen[1]["hash_rows"] == [(2, 0), (1, 0), (1, 0)]
    assert seen[1]["budget_rows"] == ["hash", "hash"]


def test_a_window_above_the_cut_is_one_device_window(ledgers, rings,
                                                     monkeypatch):
    """min_device_lanes=1: the window runs K2's plain version on the CPU
    (through a fresh arena) and the ledger charges it as device time."""
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    pubs, msgs, sigs = _ed_lanes(3, seed=b"\x12")
    co = coalesce.VerifyCoalescer(device="cpu", window_us=200,
                                  min_device_lanes=1)
    co.start()
    try:
        with devledger.caller_class("commit-verify"):
            assert co.try_verify(pubs, msgs, sigs) == [True] * 3
    finally:
        co.stop()
    occ = devledger.occupancy()["verify"]
    assert (occ["windows"], occ["device_windows"]) == (1, 1)
    assert co.device_windows == 1
    cell = devledger.cell(V, CID["commit-verify"])
    assert cell["lanes"] == 3 and cell["exec_ns"] > 0 and cell["host_ns"] == 0
    assert occ["readback_s"] > 0
    _reconciled(devledger, V)


def test_a_mixed_hash_window_charges_device_and_host_apart(ledgers, rings):
    """Two 1-block lanes reach the pinned cut of 2 and launch (X4's plain
    version on the CPU); the lone 2-block lane of the same window hashes
    inline. One ticket carries all three, so its cell holds both."""
    co = hashplane.HashCoalescer(device="cpu", window_us=200,
                                 min_device_lanes=2)
    co.start()
    try:
        with devledger.caller_class("merkle"):
            got = co.submit([b"x" * 10, b"y" * 20, b"z" * 100]).result(5)
    finally:
        co.stop()
    assert len(got) == 3
    assert co.device_windows == 1 and co.host_lanes == 1
    cell = devledger.cell(H, CID["merkle"])
    assert cell["exec_ns"] > 0 and cell["host_ns"] > 0
    assert [(r["lanes"], r["device"]) for r in health.recorder().dump()
            if r["event"] == "hash.flush"] == [(3, 1)]
    _reconciled(devledger, H)


def test_fl_msg_reads_the_window_order_as_the_reference():
    """fl_msg(fl, i): message i of an in-flight window, in window order
    across its tickets (the reference keeps per-ticket wire copies, the
    port the window's list)."""
    groups = [[b"a", b"bb"], [b"ccc"], [b"d" * 70, b"e"]]
    msgs = [m for g in groups for m in g]
    ref_fl = ref_hashplane._Inflight(
        [], [None] * len(msgs), [(None, g) for g in groups], len(msgs),
        "size")
    fl = hashplane._Inflight([], [None] * len(msgs), [], msgs, "size", 0.0,
                             0.0)
    assert [hashplane.fl_msg(fl, i) for i in range(len(msgs))] == [
        ref_hashplane.fl_msg(ref_fl, i) for i in range(len(msgs))] == msgs


def test_an_expired_deadline_raises_where_the_reference_returns_none():
    """The stated departure: past its request deadline the reference's
    try_verify answers None (its caller then verifies on the host); the
    port raises TimeoutError and submits nothing. Nested scopes tighten."""
    pubs, msgs, sigs = _ed_lanes(1, seed=b"\x13")
    ref_co = ref_coalesce.VerifyCoalescer(device=False, window_us=200)
    port_co = coalesce.VerifyCoalescer(device="cpu", window_us=200)
    plane = hashplane.HashCoalescer(device="cpu", window_us=200)
    for co in (ref_co, port_co, plane):
        co.start()
    try:
        past = time.monotonic() - 1.0
        with ref_coalesce.request_deadline(past):
            assert ref_co.try_verify(pubs, msgs, sigs) is None
        with coalesce.request_deadline(past):
            with pytest.raises(TimeoutError):
                port_co.try_verify(pubs, msgs, sigs)
            with pytest.raises(TimeoutError):
                plane.try_hash_many([b"m"])
        assert port_co.tickets == 0 and plane.tickets == 0
        for mod in (ref_coalesce, coalesce):
            assert mod.deadline_remaining() is None
            with mod.request_deadline(time.monotonic() + 5):
                with mod.request_deadline(time.monotonic() + 50):
                    assert mod.deadline_remaining() <= 5
                assert mod.deadline_remaining() <= 5
            assert mod.deadline_remaining() is None
        # a live deadline caps the wait and lets the verdict through
        with coalesce.request_deadline(time.monotonic() + 30):
            assert port_co.try_verify(pubs, msgs, sigs) == [True]
    finally:
        for co in (ref_co, port_co, plane):
            co.stop()


def test_knobs_and_modes_read_as_the_reference_reads_them(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_HASH_WINDOW_US", "250")
    monkeypatch.setenv("COMETBFT_TPU_HASH_MAX_LANES", "999999")
    monkeypatch.setenv("COMETBFT_TPU_HASH_MIN_DEVICE_LANES", "7")
    monkeypatch.setenv("COMETBFT_TPU_HASH_INFLIGHT", "3")
    ref_co = ref_hashplane.HashCoalescer(device=False)
    co = hashplane.HashCoalescer(device="cpu")
    for k in ("window_s", "max_lanes", "min_device_lanes", "max_inflight"):
        assert getattr(co, k) == getattr(ref_co, k), k
    assert co.max_lanes == hashplane.osha.MAX_LANES  # the kernel's cap
    assert hashplane.HashCoalescer(device="cpu", max_inflight=1,
                                   min_device_lanes=2).max_inflight == 1
    for value in ("1", "off", "auto", "junk"):
        monkeypatch.setenv("COMETBFT_TPU_HASH", value)
        monkeypatch.setenv("COMETBFT_TPU_COALESCE", value)
        assert hashplane.configured_mode() == ref_hashplane.configured_mode()
        assert coalesce.configured_mode() == ref_coalesce.configured_mode()
        if value in ("1", "off"):
            assert hashplane.node_wants_hashplane() == (value == "1")
            assert coalesce.node_wants_coalescer() == (value == "1")
