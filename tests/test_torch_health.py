"""The port's flight recorder, budget and critical path (libs/health),
held against the JAX package's.

* The same records under the same ring clock (``set_clock``) give equal
  ``dump()``, ``export_ring()``, ``slis()``, ``budget()`` and
  ``critical_path()``, on a seeded stream of every event code and on a
  ring that wraps.
* ``budget_from_events`` and ``critical_path_from_events`` give equal
  results on the reference tests' own event lists
  (tests/test_devledger.py, tests/test_health.py).
* ``fault_kind_codes``, ``ring_event_codes`` and ``histogram_quantile``
  are equal.
"""

import json
import time

import numpy as np
import pytest

from cometbft_tpu.libs import health as ref_health
from cometbft_tpu.libs import metrics as ref_metrics
from cometbft_tpu_torch.libs import health
from cometbft_tpu_torch.libs import metrics as port_metrics

BOTH = (ref_health, health)


@pytest.fixture
def rings(monkeypatch):
    """Both recorders on, empty, with a fresh origin table and a fixed
    monotonic clock (slis' step age reads it); restored after."""
    was = [(h.enabled(), h.recorder().capacity) for h in BOTH]
    for h in BOTH:
        monkeypatch.setattr(h, "_ORIGIN_NAMES", ["local"])
        monkeypatch.setattr(h, "_ORIGIN_IDS", {"local": 0})
        h.reset()
    monkeypatch.setattr(time, "monotonic", lambda: 5_000.0)
    yield
    for h, (on, cap) in zip(BOTH, was):
        h.set_ring_capacity(cap)
        h.reset()
        h.enable() if on else h.disable()


class _RingClock:
    """A ring clock advancing ``step`` ns a read."""

    def __init__(self, t0=1_700_000_000_000_000_000, step=7_919):
        self.t = t0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _stream(seed: int, heights: int = 6) -> list[tuple]:
    """(code, height, round, a, b) rows of every code, seeded: per height
    its Prevote and Commit steps and its commit, with plane budget, fsync,
    spec, lock, profiler, gossip, tx, vote, hash and fault rows around."""
    rng = np.random.default_rng(seed)
    rows = []
    for h in range(1, heights + 1):
        ints = lambda lo, hi, n=None: rng.integers(lo, hi, n).tolist()
        rows.append((ref_health.EV_STEP, h, 0, 1, 0))
        rows.append((ref_health.EV_PROPOSAL, h, 0, ints(0, 2), 0))
        rows.append((ref_health.EV_STEP, h, 0, 4, 0))
        for code in rng.permutation(np.arange(9, 17)).tolist():
            a, b = ints(0, 2_000_000, 2)
            r = ints(0, 3)
            if code == ref_health.EV_LOCK:
                b = ints(0, 2)  # site 0 ("?"), wait or hold
                r = ints(0, 80)
            elif code == ref_health.EV_FAULT:
                a = ints(0, 13)
            elif code == ref_health.EV_SPEC:
                a = ints(0, 4)
            elif code == ref_health.EV_PROF:
                r = ints(0, 20)
            elif code == ref_health.EV_TX:
                a = ints(-(1 << 62), 1 << 62)
                r = ints(0, 7)
            elif code == ref_health.EV_GOSSIP:
                a = ints(0, 12)
            rows.append((code, h, r, a, b))
        rows.append((ref_health.EV_VOTE, h, 0, 2, ints(0, 100)))
        rows.append((ref_health.EV_FSYNC, 0, 0, ints(1, 500_000),
                     ints(0, 2)))
        rows.append((ref_health.EV_STEP, h, 0, 8, 0))
        rows.append((ref_health.EV_WATCHDOG, 0, 0, 1 << ints(0, 8), 0))
        rows.append((ref_health.EV_BUDGET, 0, ints(0, 2),
                     ints(0, 100_000), ints(0, 100_000)))
        rows.append((ref_health.EV_COMMIT, h, ints(0, 2),
                     ints(100_000, 900_000), ints(0, 50)))
    rows.append((ref_health.EV_BREAKER, 0, 0, 1, 0))
    rows.append((ref_health.EV_RECOMPILE, 0, 0, 64, 0))
    return rows


def _record_all(h, rows, ring):
    h.enable(ring=ring)
    h.reset()
    prev = h.set_clock(_RingClock(), "virtual")
    try:
        oid = h.register_origin("n1")
        for i, row in enumerate(rows):
            h.set_thread_origin(oid if i % 3 == 0 else 0)
            h.record(*row)
        h.set_thread_origin(0)
        return {
            "dump": h.recorder().dump(),
            "export": h.export_ring(node="n1"),
            "slis": h.slis(),
            "status": h.recorder().status(),
            "budget": h.budget(),
            "critical_path": h.critical_path(),
        }
    finally:
        h.set_clock(*prev)


@pytest.mark.parametrize("seed,ring", [(0, 4096), (1, 4096), (2, 64)])
def test_the_same_records_decode_alike(rings, seed, ring):
    rows = _stream(seed)
    ref, port = (_record_all(h, rows, ring) for h in BOTH)
    assert port["dump"] == ref["dump"]
    assert port["export"] == ref["export"]
    for key in ("slis", "status", "budget", "critical_path"):
        assert port[key] == ref[key], key
    assert port["export"]["domain"] == "virtual"
    if ring == 64:  # wrapped: the newest 64 rows
        assert len(port["dump"]) == 64 < len(rows)
    else:
        assert {e["event"] for e in port["dump"]} == set(
            health._CODE_NAMES.values())
        assert port["budget"]["commits"] == 6


def test_a_disabled_recorder_records_nothing(rings):
    out = []
    for h in BOTH:
        h.enable()
        h.reset()
        h.disable()
        h.record(h.EV_COMMIT, 3, 0, 1_000)
        out.append(h.recorder().status()["recorded"])
    assert out == [0, 0]


def test_acquire_release_refcount_alike(rings, monkeypatch):
    seen = []
    for h in BOTH:
        monkeypatch.setattr(h, "_acquirers", 0)
        h.disable()
        row = []
        for env in ("", "0", "1"):
            monkeypatch.setenv("COMETBFT_TPU_HEALTH", env)
            h.disable()
            h.acquire()
            h.acquire()
            row.append(h.enabled())
            h.release()
            row.append(h.enabled())
            h.release()
            row.append(h.enabled())
            monkeypatch.setattr(h, "_acquirers", 0)
        seen.append(row)
    assert seen[0] == seen[1]


# The reference tests' own event lists (tests/test_devledger.py's budget
# decomposition, tests/test_health.py's critical-path verdicts).
T0, DUR = 1_000_000_000, 200_000_000
REFERENCE_EVENTS = {
    "stages_tile_the_height": [
        {"event": "consensus.step", "ts": 1_000, "height": 7, "step": 4},
        {"event": "consensus.step", "ts": 6_000, "height": 7, "step": 8},
        {"event": "consensus.commit", "ts": 10_000, "height": 7,
         "dur_ns": 10_000},
        {"event": "plane.budget", "ts": 2_000, "plane": "verify",
         "wait_ns": 500, "exec_ns": 1_500},
        {"event": "plane.budget", "ts": 3_000, "plane": "hash",
         "wait_ns": 100, "exec_ns": 400},
        {"event": "wal.fsync", "ts": 9_000, "dur_ns": 1_000},
    ],
    "overlay_clamped_to_span": [
        {"event": "consensus.step", "ts": 1_000, "height": 3, "step": 4},
        {"event": "consensus.step", "ts": 2_000, "height": 3, "step": 8},
        {"event": "consensus.commit", "ts": 3_000, "height": 3,
         "dur_ns": 3_000},
        {"event": "plane.budget", "ts": 1_500, "plane": "verify",
         "wait_ns": 50_000, "exec_ns": 50_000},
    ],
    "missing_steps_degrade_to_residual": [
        {"event": "consensus.commit", "ts": 5_000, "height": 2,
         "dur_ns": 4_000},
    ],
    "budget_view_aggregates": [
        {"event": "consensus.commit", "ts": 2_000, "height": 1,
         "dur_ns": 1_000},
        {"event": "consensus.commit", "ts": 4_000, "height": 2,
         "dur_ns": 1_000},
    ],
    "critical_path_names_the_gating_lock": [
        {"event": "consensus.step", "height": 5, "node": "n0", "step": 4,
         "ts": T0 + 50_000_000},
        {"event": "consensus.step", "height": 5, "node": "n0", "step": 8,
         "ts": T0 + 180_000_000},
        {"event": "consensus.commit", "height": 5, "node": "n0",
         "ts": T0 + DUR, "dur_ns": DUR},
        {"event": "sync.lock", "kind_name": "wait",
         "lock": "consensus.wal._mtx", "ts": T0 + 100_000_000,
         "dur_ns": 150_000_000, "site": "wal.py:42"},
        {"event": "sync.lock", "kind_name": "hold",
         "lock": "consensus.wal._mtx", "ts": T0 + 100_000_000,
         "dur_ns": 150_000_000, "site": "wal.py:42"},
        {"event": "sync.lock", "kind_name": "wait",
         "lock": "consensus.state", "ts": T0 + 100_000_000,
         "dur_ns": 10_000_000, "site": "state.py:7"},
        {"event": "sync.lock", "kind_name": "wait",
         "lock": "store.block_store._mtx", "ts": T0 + 10 * DUR,
         "dur_ns": 900_000_000, "site": "store.py:9"},
    ],
    "critical_path_names_the_gating_cpu": [
        {"event": "consensus.step", "height": 9, "node": "n0", "step": 4,
         "ts": T0 + 50_000_000},
        {"event": "consensus.step", "height": 9, "node": "n0", "step": 8,
         "ts": T0 + 110_000_000},
        {"event": "consensus.commit", "height": 9, "node": "n0",
         "ts": T0 + DUR, "dur_ns": DUR},
        {"event": "prof.window", "subsystem": "consensus",
         "ts": T0 + 150_000_000, "oncpu_ns": 170_000_000, "samples": 12},
        {"event": "prof.window", "subsystem": "sampler",
         "ts": T0 + 150_000_000, "oncpu_ns": 999_000_000, "samples": 66},
        {"event": "prof.window", "subsystem": "mempool",
         "ts": T0 + 10 * DUR, "oncpu_ns": 900_000_000, "samples": 60},
    ],
}


@pytest.mark.parametrize("name", sorted(REFERENCE_EVENTS))
def test_budget_and_critical_path_on_the_reference_lists(name):
    events = REFERENCE_EVENTS[name]
    for fn in ("budget_from_events", "critical_path_from_events"):
        assert getattr(health, fn)(events) == getattr(ref_health, fn)(
            events), fn
    assert health.budget(events=events) == ref_health.budget(events=events)
    assert health.critical_path(events) == ref_health.critical_path(events)


def test_the_reference_lists_give_the_reference_verdicts():
    """The values the reference tests pin, read from the port."""
    s = {k: round(v * 1e9) for k, v in health.budget_from_events(
        REFERENCE_EVENTS["stages_tile_the_height"])[7]["stages"].items()}
    assert s == {"proposal_wait": 1_000, "gossip": 2_500,
                 "verify_queue": 500, "verify_execute": 1_500, "hash": 500,
                 "spec_exec": 0, "wal_fsync": 1_000, "apply": 3_000,
                 "residual": 0}
    row = health.critical_path_from_events(
        REFERENCE_EVENTS["critical_path_names_the_gating_lock"])[5]
    assert (row["gate"], row["lock_site"]) == ("lock:consensus.wal._mtx",
                                               "wal.py:42")
    row = health.critical_path_from_events(
        REFERENCE_EVENTS["critical_path_names_the_gating_cpu"])[9]
    assert row["gate"] == "cpu:consensus"


def test_code_registries_and_quantiles_match():
    assert health.fault_kind_codes() == ref_health.fault_kind_codes()
    assert health.ring_event_codes() == ref_health.ring_event_codes()
    for name in ("BUDGET_STAGES", "WALL_DURATION_CODES", "TX_STAGES",
                 "_CODE_NAMES", "_CODE_FIELDS", "_FAULT_NAMES",
                 "_WATCHDOGS", "DEFAULT_RING_SIZE"):
        assert getattr(health, name) == getattr(ref_health, name), name
    rng = np.random.default_rng(3)
    values = rng.exponential(0.05, 200).tolist() + [0.0, 2.0, 40.0]
    buckets = (0.001, 0.01, 0.05, 0.1, 1.0)
    hs = []
    for lib in (ref_metrics, port_metrics):
        h = lib.Histogram("q_test", buckets=buckets)
        for v in values:
            h.observe(v)
        hs.append(h)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert health.histogram_quantile(hs[1], q) == (
            ref_health.histogram_quantile(hs[0], q)), q


def test_debug_bodies_have_the_reference_shape(rings):
    budget = [json.loads(h.debug_budget_json()) for h in BOTH]
    assert budget[0].keys() == budget[1].keys() == {"ledger", "budget"}
    assert budget[1]["ledger"].keys() == budget[0]["ledger"].keys()
    cont = [json.loads(h.debug_contention_json()) for h in BOTH]
    assert cont[1].keys() == cont[0].keys()
    assert cont[1]["hot_lock"] is None
    assert cont[1]["critical_path"] == cont[0]["critical_path"]
