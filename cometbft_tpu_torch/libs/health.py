"""Always-on flight recorder and per-height latency budget.

Port of the part of cometbft_tpu/libs/health.py that the device planes,
the ledger and the lock profiler report to:

* **Flight recorder** (:class:`FlightRecorder`): a bounded ring of
  structured events (step transitions, vote admission, commits, hash
  flushes, plane budget rows, slow lock waits, ...), recorded even when
  the span tracer (libs/trace) is off. :func:`export_ring` is the
  portable ``/debug/flight`` body.

* **Budget and critical path** (:func:`budget_from_events`,
  :func:`critical_path_from_events`): pure functions of a decoded event
  stream that tile each committed height's latency into stages and name
  the resource that gated it.

The watchdog service (``HealthMonitor``), its black-box bundles, the SLI
engine (``sample``) and ``debug_health_json`` read the p2p, mempool and
sampling-profiler sensors (libs/netstats, libs/txtrace, libs/profile),
which the port does not have yet; they are not ported.
``debug_contention_json``'s ``hot_lock`` therefore reads None. The port
keeps the reference's decode tables for the codes those sensors record
(gossip phases, profiler subsystems), so a ring holding such rows
decodes alike.

Design constraints, as in the reference:

* **Allocation-free steady state.** The record path writes scalars into
  preallocated ``array.array`` columns; slot reservation is one
  GIL-atomic ``itertools.count`` step. Nothing is retained per record.

* **Lock-free record and scrape paths.** ``record()`` touches no lock
  (concurrent writers reserve distinct slots; a reader may observe a
  torn in-progress row, which the decoder skips). The one lock here
  (``libs.health._mtx``) serializes origin interning only.

Knobs: ``COMETBFT_TPU_HEALTH`` (auto: on while an acquirer holds it,
refcounted; 1 force; 0 off) and ``COMETBFT_TPU_HEALTH_RING`` (ring
capacity).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from array import array

from . import devledger as libdevledger
from . import lockprof as liblockprof
from . import metrics as libmetrics
from . import sync as libsync

_ENV_HEALTH = "COMETBFT_TPU_HEALTH"
_ENV_RING = "COMETBFT_TPU_HEALTH_RING"

DEFAULT_RING_SIZE = 4096

# -- ring event codes (decoded by _CODE_NAMES / dump()) -----------------
EV_STEP = 1  # height, round, a=RoundStep int
EV_PROPOSAL = 2  # height, round, a=1 accepted / 0 rejected
EV_VOTE = 3  # height, round, a=vote type, b=validator index
EV_COMMIT = 4  # height, round=commit round, a=height latency ns
EV_BREAKER = 5  # a=1 trip / 0 re-arm (crypto/coalesce half-open breaker)
EV_RECOMPILE = 6  # a=shape bucket (libs/devstats steady-state recompile)
EV_FSYNC = 7  # a=WAL fsync ns
EV_WATCHDOG = 8  # a=watchdog bit (see _WATCHDOGS)
EV_GOSSIP = 9  # a=propagation phase code (netstats.PHASE_NAMES), b=lag ns
EV_FAULT = 10  # simnet fault plane: h=src node, r=dst node, a=kind, b=detail
EV_HASH = 11  # hash-plane window flush: a=lanes, b=1 device / 0 host
# plane.budget: FSM-blocking device-plane time per window resolution —
# r=plane (libs/devledger: 0 verify / 1 hash), a=consensus-caller
# queue-wait ns, b=consensus-caller pro-rata execute ns. The per-height
# latency budget (budget_from_events) window-assigns these rows to the
# height they delayed, exactly like EV_FSYNC.
EV_BUDGET = 12
# tx.stage: one sampled transaction crossing a lifecycle stage
# (libs/txtrace): r=stage code (TX_STAGES), a=signed 64-bit key
# fingerprint (first 8 key bytes; decoded as the 16-hex-char ``key``
# prefix), b=stage payload — mempool depth at admit, one-hop lag ns at
# gossip_recv, ns-since-admit at gossip_send/commit. Stamped from the
# ring clock, so virtual-domain (simnet) rows stay merge-consistent.
EV_TX = 13
# sync.lock: a lock wait or hold crossed the lockprof slow threshold
# (libs/lockprof, COMETBFT_TPU_LOCKPROF_SLOW_MS) — r=lockorder.json
# registry slot (decoded to the ``lock`` name), a=duration ns,
# b=site_idx*2+kind (kind 0 wait / 1 hold; site_idx indexes lockprof's
# interned holder-acquire-site table, decoded as ``site``). Bundles
# name the blocker, not just the victim.
EV_LOCK = 14
# prof.window: one sampling-profiler flush window for one subsystem
# (libs/profile, ~1/s per subsystem with samples) — r=subsystem index
# (libs/profile.SUBSYSTEMS, decoded as ``subsystem``), a=estimated
# on-CPU ns (on-CPU samples x the sampling period), b=total samples
# (on-CPU + blocked). critical_path_from_events window-assigns these to
# name commits gated by GIL-bound Python (``cpu:<subsystem>``), and the
# cpu_saturated postmortem detector scores them.
EV_PROF = 15
# spec.exec: one speculative block execution resolved by the commit
# pipeline (consensus/pipeline) — a=outcome code (_SPEC_OUTCOMES:
# 1 hit / 2 miss / 3 abort), b=speculative FinalizeBlock execute ns
# (0 for miss/abort rows — there is nothing to credit). Recorded at
# consumption/discard time on the FSM thread, so the row sits inside
# the commit window budget_from_events assigns it to.
EV_SPEC = 16

_N_CODES = 17  # size of the per-code last-seen vector

# EV_SPEC outcome vocabulary (recorded by consensus/pipeline)
SPEC_HIT = 1  # precommitted block matched the memoized speculation
SPEC_MISS = 2  # nothing memoized for the committed block — serial path
SPEC_ABORT = 3  # speculation discarded (superseded / failed) unconsumed

_SPEC_OUTCOMES = {SPEC_HIT: "hit", SPEC_MISS: "miss", SPEC_ABORT: "abort"}

# EV_TX stage vocabulary (the decode side of libs/txtrace's stage
# codes — the decoder lives here with the rest of the ring vocabulary,
# txtrace aliases this map so the two cannot diverge)
TX_STAGES = {
    1: "admit",
    2: "gossip_send",
    3: "gossip_recv",
    4: "proposal",
    5: "commit",
}

# EV_FAULT kinds (recorded by the reference's network simulator): the black-box ring
# explains WHICH fault was live when a scenario failed — a partition
# forming, a link dropping a message class, a node crashing mid-height.
FAULT_PARTITION = 1  # partition formed (detail = group count)
FAULT_HEAL = 2  # partition healed
FAULT_KILL = 3  # node killed (churn)
FAULT_RESTART = 4  # node restarted (churn)
FAULT_DROP = 5  # one message eaten by link faults (detail = channel)
FAULT_LINK = 6  # link fault parameters changed
FAULT_CRASH = 7  # armed COMETBFT_TPU_FAIL crash point fired in-process
# gray-failure vocabulary: slow-but-alive and asymmetric faults
FAULT_ONEWAY = 8  # one DIRECTION severed (h=src, r=dst; detail 1=sever 0=restore)
FAULT_SLOW_DISK = 9  # node's disk slowed (h=node; detail = latency ms, 0=cleared)
FAULT_STORM = 10  # sustained mempool storm (detail = tx/s rate, 0=stopped)
FAULT_PEER_EVICT = 11  # a node-side DEFENSE evicted a peer (suspicion /
# statesync chunk-peer rotation); h=node where known, detail=reason code
# FAULT_PEER_EVICT detail namespace (WHICH defense acted): 1-4 are the
# p2p/suspicion reason enum (queue_full/stale/lag/mixed); 5 is a
# statesync chunk-fetch rotation abandoning a timing-out chunk peer
PEER_EVICT_STATESYNC_ROTATE = 5

_FAULT_NAMES = {
    FAULT_PARTITION: "partition",
    FAULT_HEAL: "heal",
    FAULT_KILL: "kill",
    FAULT_RESTART: "restart",
    FAULT_DROP: "drop",
    FAULT_LINK: "link_change",
    FAULT_CRASH: "crash_point",
    FAULT_ONEWAY: "oneway_sever",
    FAULT_SLOW_DISK: "slow_disk",
    FAULT_STORM: "mempool_storm",
    FAULT_PEER_EVICT: "peer_evict",
}


def fault_kind_codes() -> dict[str, int]:
    """Every ``FAULT_*`` kind this module defines, by constant name —
    the registry the EV_FAULT decode-completeness tier-1 test walks, so
    a new fault kind cannot ship without a ``fault_name`` decode entry
    and a docs row."""
    return {
        name: value
        for name, value in globals().items()
        if name.startswith("FAULT_") and isinstance(value, int)
    }

_CODE_NAMES = {
    EV_STEP: "consensus.step",
    EV_PROPOSAL: "consensus.proposal",
    EV_VOTE: "consensus.vote",
    EV_COMMIT: "consensus.commit",
    EV_BREAKER: "coalesce.breaker",
    EV_RECOMPILE: "xla.recompile",
    EV_FSYNC: "wal.fsync",
    EV_WATCHDOG: "health.watchdog",
    EV_GOSSIP: "p2p.gossip",
    EV_FAULT: "simnet.fault",
    EV_HASH: "hash.flush",
    EV_BUDGET: "plane.budget",
    EV_TX: "tx.stage",
    EV_LOCK: "sync.lock",
    EV_PROF: "prof.window",
    EV_SPEC: "spec.exec",
}
# decode the free-form a/b columns per code
_CODE_FIELDS = {
    EV_STEP: ("step", None),
    EV_PROPOSAL: ("accepted", None),
    EV_VOTE: ("type", "index"),
    EV_COMMIT: ("dur_ns", "txs"),
    EV_BREAKER: ("open", None),
    EV_RECOMPILE: ("bucket", None),
    # overlapped=1 marks an fsync that ran OFF the FSM critical section
    # (the pipelined commit-writer, consensus/pipeline): the budget
    # plane excludes it from the serial wal_fsync stage and reports it
    # in the per-height ``overlapped`` credit instead
    EV_FSYNC: ("dur_ns", "overlapped"),
    EV_WATCHDOG: ("watchdog", None),
    EV_GOSSIP: ("phase", "lag_ns"),
    EV_FAULT: ("kind", "detail"),
    EV_HASH: ("lanes", "device"),
    EV_BUDGET: ("wait_ns", "exec_ns"),
    EV_TX: ("key_fp", "val"),
    EV_LOCK: ("dur_ns", "ref"),
    EV_PROF: ("oncpu_ns", "samples"),
    EV_SPEC: ("outcome", "dur_ns"),
}

# codes whose payload is a wall-clock-measured duration: meaningless in
# a virtual-time (simnet) ring, so the cross-node timeline merge drops
# them from virtual-domain sources — EV_PROF
# rides along because its on-CPU estimate is sampled in wall time
WALL_DURATION_CODES = frozenset(
    {EV_FSYNC, EV_BUDGET, EV_LOCK, EV_PROF, EV_SPEC}
)


def ring_event_codes() -> dict[str, int]:
    """Every ``EV_*`` code this module defines, by constant name — the
    registry the decoder-completeness tier-1 test walks, so a new event
    code cannot ship without a decode path and a docs entry."""
    return {
        name: value
        for name, value in globals().items()
        if name.startswith("EV_") and isinstance(value, int)
    }

_STEP_NAMES = {
    1: "NewHeight", 2: "NewRound", 3: "Propose", 4: "Prevote",
    5: "PrevoteWait", 6: "Precommit", 7: "PrecommitWait", 8: "Commit",
}

# watchdog name -> trip bitmask returned by HealthMonitor._check
_WATCHDOGS = (
    ("consensus_stall", 1),
    ("verify_breaker", 2),
    ("recompile_storm", 4),
    ("send_queue_saturated", 8),
    ("slow_disk", 16),
    ("consensus_starved", 32),
    ("tx_starved", 64),
    ("lock_contended", 128),
)
_WATCHDOG_NAMES = {bit: name for name, bit in _WATCHDOGS}

_ON_VALUES = ("1", "on", "true", "yes")
_OFF_VALUES = ("0", "off", "false", "no")


def _env_mode() -> str:
    v = os.environ.get(_ENV_HEALTH, "").lower()
    if v in _ON_VALUES:
        return "on"
    if v in _OFF_VALUES:
        return "off"
    return "auto"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _ring_size_from_env() -> int:
    try:
        n = int(os.environ.get(_ENV_RING, ""))
    except ValueError:
        n = DEFAULT_RING_SIZE
    return max(64, n)


# Decode tables of the sensors the port does not have yet, kept as the
# reference defines them (libs/netstats.PHASES, libs/profile.SUBSYSTEMS)
# so that EV_GOSSIP and EV_PROF rows decode alike.
_GOSSIP_PHASES = (
    "proposal", "block_part", "prevote", "precommit", "commit",
    "block", "tx", "state", "vote", "evidence",
)
_GOSSIP_PHASE_NAMES = {i + 1: name for i, name in enumerate(_GOSSIP_PHASES)}
_PROF_SUBSYSTEMS = (
    "unknown", "consensus", "p2p", "mempool", "coalescer", "hashplane",
    "light", "blocksync", "rpc", "statesync", "abci", "privval", "health",
    "trace", "load", "simnet", "main", "sampler", "other",
)


def _subsystem_name(idx: int) -> str:
    return (_PROF_SUBSYSTEMS[idx] if 0 <= idx < len(_PROF_SUBSYSTEMS)
            else "?")


# ----------------------------------------------- ring clock + origins

# Injectable ring timestamp source: the simnet plane swaps in its
# virtual clock (SimClock.time_ns) for the run's lifetime, so every
# ring row of an N-node simulation carries EXACT shared virtual time —
# the property that makes the cross-node timeline merge lossless there.
# Live nodes keep the wall clock and the merge tags cross-node edges
# with a netstamp-derived skew bound instead.
_now_ns = time.time_ns
_clock_domain = "wall"  # "wall" | "virtual" — exported with the ring


def now_ns() -> int:
    """The ring clock (wall on live nodes, the shared virtual clock
    under simnet) — sibling planes (libs/txtrace, the mempool admit
    stamps) read it so their durations stay domain-consistent with the
    ring rows they sit next to."""
    return _now_ns()


def set_clock(fn, domain: str = "wall"):
    """Swap the ring timestamp source; returns the previous
    ``(fn, domain)`` pair so the caller can restore it."""
    global _now_ns, _clock_domain
    prev = (_now_ns, _clock_domain)
    _now_ns = fn
    _clock_domain = domain
    return prev


def clock_domain() -> str:
    return _clock_domain


# Origin attribution: which NODE a ring row belongs to.  One process
# usually hosts one node (origin = its node-id prefix, registered at
# boot), but the simnet plane and the in-process test nets host N — the
# recording THREAD declares its origin (simnet sets it per scheduler
# event; live nodes set it on the cs-receive and mconn-recv threads
# they own), and the decoder emits it as the row's ``node`` field.  The
# record-path read is one thread-local getattr: allocation- and
# lock-free, covered by the tracemalloc guard.
_ORIGIN_NAMES: list[str] = ["local"]  # id 0 = unattributed/this-process
_ORIGIN_IDS: dict[str, int] = {"local": 0}
_origin_tls = threading.local()


def register_origin(name: str) -> int:
    """Intern an origin name -> id (dedupes, so re-registration across
    node restarts and repeated simnet runs is stable).  Registration is
    a setup-path operation (node boot, peer admit) under ``_mtx``."""
    with _mtx:
        oid = _ORIGIN_IDS.get(name)
        if oid is None:
            oid = len(_ORIGIN_NAMES)
            _ORIGIN_NAMES.append(name)
            _ORIGIN_IDS[name] = oid
        return oid


def origin_name(oid: int) -> str:
    names = _ORIGIN_NAMES
    return names[oid] if 0 <= oid < len(names) else "?"


def set_thread_origin(oid: int) -> None:
    """Declare the node whose events this thread records (0 clears)."""
    _origin_tls.oid = oid


def current_thread_origin() -> int:
    return getattr(_origin_tls, "oid", 0)


# ------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded lock-free ring of fixed-width consensus events.

    Storage is six parallel ``array.array('q')`` columns plus a
    per-code last-seen ``array('d')`` vector, all preallocated: the
    record path performs only C-level scalar stores, so steady-state
    recording retains zero allocations.  Concurrent writers reserve
    slots through one GIL-atomic ``itertools.count``; a reader racing a
    writer may see one torn row (skipped by the decoder), never a
    corrupt structure.
    """

    __slots__ = (
        "capacity", "_ts", "_code", "_h", "_r", "_a", "_b", "_o",
        "_seq", "_written", "_last", "_commits",
    )

    def __init__(self, capacity: int = DEFAULT_RING_SIZE):
        self.capacity = max(64, int(capacity))
        zeros = [0] * self.capacity
        self._ts = array("q", zeros)
        self._code = array("q", zeros)
        self._h = array("q", zeros)
        self._r = array("q", zeros)
        self._a = array("q", zeros)
        self._b = array("q", zeros)
        self._o = array("q", zeros)  # recording thread's origin id
        self._seq = itertools.count()
        self._written = array("q", [0])
        # monotonic last-seen per event code (watchdog math)
        self._last = array("d", [0.0] * _N_CODES)
        # commit-row tally: the budget memo's invalidation key — the
        # per-height decomposition only changes when a height closes
        self._commits = array("q", [0])

    def record(
        self, code: int, height: int = 0, round_: int = 0,
        a: int = 0, b: int = 0,
    ) -> None:
        seq = next(self._seq)  # GIL-atomic slot reservation
        i = seq % self.capacity
        self._code[i] = 0  # mark in-progress: readers skip torn rows
        self._ts[i] = _now_ns()
        self._h[i] = height
        self._r[i] = round_
        self._a[i] = a
        self._b[i] = b
        self._o[i] = getattr(_origin_tls, "oid", 0)
        self._code[i] = code  # publish last
        if code == EV_STEP:
            # the one last-seen the stall watchdog consumes; the other
            # codes skip the extra clock read on the hot path
            self._last[EV_STEP] = time.monotonic()
        elif code == EV_COMMIT:
            self._commits[0] = self._commits[0] + 1
        if seq >= self._written[0]:
            self._written[0] = seq + 1

    def last_seen(self, code: int) -> float:
        """Monotonic time the code was last recorded (0.0 = never;
        maintained for EV_STEP only — the stall watchdog's signal)."""
        return self._last[code]

    def _iter_slots(self):
        """(slot index) oldest-first over the currently-filled window."""
        w = self._written[0]
        n = min(w, self.capacity)
        for k in range(w - n, w):
            yield k % self.capacity

    def dump(self) -> list[dict]:
        """Decoded ring contents, oldest first (lock-free snapshot; a
        row being written concurrently is skipped)."""
        out = []
        for i in self._iter_slots():
            code = self._code[i]
            name = _CODE_NAMES.get(code)
            if name is None:
                continue  # empty or torn slot
            rec = {
                "ts": self._ts[i],
                "event": name,
                "height": self._h[i],
                "round": self._r[i],
            }
            # .get with a null default, not [code]: a code registered in
            # _CODE_NAMES but missing its field entry must decode (as
            # raw a/b-less row), never KeyError a scrape/bundle path —
            # the completeness test still flags the gap
            fa, fb = _CODE_FIELDS.get(code, (None, None))
            if fa is not None:
                rec[fa] = self._a[i]
            if fb is not None:
                rec[fb] = self._b[i]
            if code == EV_STEP:
                rec["step_name"] = _STEP_NAMES.get(self._a[i], "?")
            elif code == EV_WATCHDOG:
                rec["watchdog_name"] = _WATCHDOG_NAMES.get(self._a[i], "?")
            elif code == EV_GOSSIP:
                rec["phase_name"] = _GOSSIP_PHASE_NAMES.get(
                    self._a[i], "?"
                )
                if self._r[i] > 0:
                    # simnet delivery rows park the SENDING node's
                    # origin id in the round column (live rows leave 0)
                    rec["src"] = origin_name(self._r[i])
            elif code == EV_FAULT:
                rec["fault_name"] = _FAULT_NAMES.get(self._a[i], "?")
            elif code == EV_BUDGET:
                # the plane rides the round column (libs/devledger
                # plane codes); heightless rows keep round=plane
                rec["plane"] = libdevledger.PLANES[
                    self._r[i] % len(libdevledger.PLANES)
                ]
            elif code == EV_TX:
                # the stage rides the round column; the key exports as
                # its bounded 16-hex-char prefix, never the raw key
                rec["stage_name"] = TX_STAGES.get(self._r[i], "?")
                rec["key"] = format(self._a[i] % (1 << 64), "016x")
            elif code == EV_LOCK:
                # the registry slot rides the round column; b packs
                # kind (low bit) + interned holder-acquire-site index
                rec["lock"] = liblockprof.slot_name(self._r[i])
                rec["kind_name"] = liblockprof.KIND_NAMES.get(
                    self._b[i] & 1, "?"
                )
                rec["site"] = liblockprof.site_name(self._b[i] >> 1)
            elif code == EV_PROF:
                # the subsystem index rides the round column
                rec["subsystem"] = _subsystem_name(self._r[i])
            elif code == EV_SPEC:
                rec["outcome_name"] = _SPEC_OUTCOMES.get(self._a[i], "?")
            o = self._o[i]
            if o:
                rec["node"] = origin_name(o)
            out.append(rec)
        return out

    def slis(self) -> dict:
        """SLIs derived from the ring: commit-latency quantiles,
        rounds-per-height, WAL fsync lag, step-progress age."""
        commits: list[float] = []
        rounds: list[int] = []
        fsyncs: list[float] = []
        for i in self._iter_slots():
            code = self._code[i]
            if code == EV_COMMIT:
                commits.append(self._a[i] / 1e9)
                rounds.append(self._r[i] + 1)
            elif code == EV_FSYNC:
                fsyncs.append(self._a[i] / 1e9)
        last_step = self._last[EV_STEP]
        return {
            "commits": len(commits),
            "commit_latency_s": {
                "last": round(commits[-1], 6) if commits else None,
                "p50": _quantile(commits, 0.50),
                "p99": _quantile(commits, 0.99),
            },
            "rounds_per_height": (
                round(sum(rounds) / len(rounds), 3) if rounds else None
            ),
            "wal_fsync_p99_s": _quantile(fsyncs, 0.99),
            "step_age_s": (
                round(time.monotonic() - last_step, 3) if last_step else None
            ),
        }

    def status(self) -> dict:
        return {
            "capacity": self.capacity,
            "recorded": self._written[0],
        }


def _quantile(values: list[float], q: float) -> float | None:
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, int(q * len(vs)))
    return round(vs[idx], 6)


def histogram_quantile(h, q: float) -> float:
    """Upper-bound quantile estimate from a libs/metrics Histogram's
    cumulative buckets (the promql-style read).  Unlocked GIL-consistent
    snapshot: the scrape path must not contend with observers.  The
    math lives in the shared :func:`libmetrics.quantile_from_buckets`
    estimator (one implementation for health, netstats and the
    device-ledger budget plane)."""
    return libmetrics.quantile_from_buckets(h.buckets, list(h._counts), q)


# -------------------------------------------------- module-level recorder

_mode = _env_mode()
_enabled: bool = _mode == "on"
# reference count of node-lifecycle holders (every booting node acquires
# unless the env knob pins health off) — "always-on" means on for every
# running node with zero opt-in, while bare library use stays free
_acquirers = 0

_REC = FlightRecorder(_ring_size_from_env())

# origin interning only (a setup path, never the record path)
_mtx = libsync.Mutex("libs.health._mtx")

# breaker-trip notices (the reference's coalescer breaker; the port has
# no breaker, so nothing calls the hooks below: they stay so that the
# EV_BREAKER vocabulary decodes alike)
_BREAKER_NOTICES = array("q", [0])


def enabled() -> bool:
    """The one check hot paths make before recording."""
    return _enabled


def enable(ring: int | None = None) -> None:
    """Force the recorder on (tests, bench).  ``ring`` rebuilds the
    buffer at a new capacity, dropping prior records."""
    global _enabled, _REC
    if ring is not None and ring != _REC.capacity:
        _REC = FlightRecorder(ring)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all buffered records (tests, bench bursts)."""
    global _REC
    _REC = FlightRecorder(_REC.capacity)


def set_ring_capacity(n: int) -> None:
    """Rebuild the ring at a new capacity WITHOUT touching the enabled
    flag (simnet scenario runs size the ring to hold a whole run's
    gossip-annotated event stream, then restore the prior capacity)."""
    global _REC
    n = max(64, int(n))
    if n != _REC.capacity:
        _REC = FlightRecorder(n)


def export_ring(node: str | None = None) -> dict:
    """The portable flight-ring export: the ``/debug/flight`` pprof
    body, in the shape a cross-node timeline merge consumes.

    ``domain`` says which clock stamped the rows ("wall" for live
    nodes, "virtual" for simnet rings — where the shared clock makes a
    cross-node merge exact); ``origins`` is the interned origin-name
    table the per-row ``node``/``src`` fields were decoded from."""
    return {
        "schema": 1,
        "node": node,
        "domain": _clock_domain,
        "origins": list(_ORIGIN_NAMES),
        # per-peer clock-skew bounds come from p2p round trips, which
        # the port does not have: no peer, no bound
        "skews": {},
        "ring": _REC.status(),
        "events": _REC.dump(),
    }


# ------------------------------------------------- per-height budget

# The stage vocabulary of the per-height latency budget — the ``stage``
# label of height_budget_seconds and the keys of every budget row.
BUDGET_STAGES = (
    "proposal_wait",  # enter-height -> Prevote step (proposal receipt)
    "gossip",  # vote-gathering wall time net of plane overlays
    "verify_queue",  # consensus-caller coalescer queue wait
    "verify_execute",  # consensus-caller pro-rata verify execute
    "hash",  # FSM-adjacent hash-plane time (merkle/mempool)
    "spec_exec",  # speculative FinalizeBlock time consumed by a hit
    "wal_fsync",  # FSM-blocking WAL fsync durations in the height window
    "apply",  # Commit step -> applied, net of fsync overlay
    "residual",  # whatever the named stages don't explain
)

_STEP_PREVOTE = 4  # RoundStep.PREVOTE in the EV_STEP step column
_STEP_COMMIT = 8  # RoundStep.COMMIT


def budget_from_events(events) -> dict[int, dict]:
    """Decompose each committed height's latency into BUDGET_STAGES.

    Input is a decoded event stream (``FlightRecorder.dump()`` rows, a
    ``flight.json`` export's ``events``, or a merged multi-node
    stream).  Per height: the EARLIEST commit row anchors the window
    ``[commit_ts - latency, commit_ts]``; that node's first Prevote and
    Commit step rows split it into proposal / vote-gathering / apply
    spans; ``plane.budget`` (EV_BUDGET) and ``wal.fsync`` rows are
    window-assigned by timestamp as overlays, and each span reports its
    remainder — so the stages tile the measured latency and
    ``coverage`` (stage sum / latency) sits at ~1.0 on a healthy burst.
    Pure function: deterministic for a given event list (the timeline
    merge reuses it for its per-height budget rows)."""
    commits: dict[int, tuple] = {}
    steps: dict[tuple, dict] = {}
    planes: list[tuple] = []
    fsyncs: list[tuple] = []
    specs: list[tuple] = []
    for ev in events:
        name = ev.get("event")
        if name == "consensus.commit":
            h = ev.get("height", 0)
            if h:
                cur = commits.get(h)
                if cur is None or ev.get("ts", 0) < cur[0]:
                    commits[h] = (
                        ev.get("ts", 0), ev.get("dur_ns", 0),
                        ev.get("node"),
                    )
        elif name == "consensus.step":
            h = ev.get("height", 0)
            if h:
                d = steps.setdefault((h, ev.get("node")), {})
                s = ev.get("step")
                if s not in d:
                    d[s] = ev.get("ts", 0)
        elif name == "plane.budget":
            planes.append((
                ev.get("ts", 0), ev.get("plane"),
                ev.get("wait_ns", 0), ev.get("exec_ns", 0),
            ))
        elif name == "wal.fsync":
            fsyncs.append((
                ev.get("ts", 0), ev.get("dur_ns", 0),
                ev.get("overlapped", 0),
            ))
        elif name == "spec.exec":
            specs.append((
                ev.get("ts", 0), ev.get("outcome", 0),
                ev.get("dur_ns", 0),
            ))
    out: dict[int, dict] = {}
    for h in sorted(commits):
        cts, dur, node = commits[h]
        if dur <= 0:
            continue
        t0 = cts - dur
        sd = steps.get((h, node), {})
        t_pv = sd.get(_STEP_PREVOTE)
        t_cm = sd.get(_STEP_COMMIT)
        have_steps = t_pv is not None
        e1 = min(max(t_pv, t0), cts) if t_pv else cts
        e2 = min(max(t_cm, e1), cts) if t_cm else cts

        def _span(ts: int) -> int:
            if ts <= e1:
                return 0
            return 1 if ts <= e2 else 2

        # per span: [verify_wait, verify_exec, hash, fsync, spec_exec]
        ov = [[0] * 5, [0] * 5, [0] * 5]
        # overlapped credit: work the pipelined commit moved OFF the
        # serial span (flagged fsyncs; a winning speculation's execute
        # time beyond what the span clamp can absorb). Reported beside
        # the stages — never inside them — so the tiling still covers
        # exactly the FSM-blocking latency without double-counting.
        overlapped_fsync = 0
        for ts, plane, w, x in planes:
            if t0 <= ts <= cts:
                k = _span(ts)
                if plane == "verify":
                    ov[k][0] += w
                    ov[k][1] += x
                else:
                    ov[k][2] += w + x
        for ts, d, lap in fsyncs:
            if t0 <= ts <= cts:
                if lap:
                    overlapped_fsync += d
                else:
                    ov[_span(ts)][3] += d
        for ts, outcome, d in specs:
            if t0 <= ts <= cts and outcome == SPEC_HIT:
                ov[_span(ts)][4] += d
        # Clamp each span's overlay total to the span's wall length:
        # FSM-blocking time inside a span cannot exceed the span, but
        # a shared multi-node ring (in-process nets, simnet) assigns
        # every node's plane rows to the one committing node's window,
        # and concurrent-thread callers (CheckTx hashing, the spec-exec
        # worker) overlap the FSM wall — scaling the components
        # pro-rata keeps the stage tiling honest (coverage ~1.0)
        # instead of double-counting.
        spans = (e1 - t0, e2 - e1, cts - e2)
        overlapped_spec = 0
        for k in range(3):
            tot = sum(ov[k])
            if tot > spans[k] > 0:
                scaled_spec = ov[k][4] * spans[k] // tot
                overlapped_spec += ov[k][4] - scaled_spec
                for j in range(5):
                    ov[k][j] = ov[k][j] * spans[k] // tot
            elif tot > 0 and spans[k] <= 0:
                overlapped_spec += ov[k][4]
                ov[k] = [0] * 5
        vq = ov[0][0] + ov[1][0] + ov[2][0]
        vx = ov[0][1] + ov[1][1] + ov[2][1]
        hs = ov[0][2] + ov[1][2] + ov[2][2]
        fs = ov[0][3] + ov[1][3] + ov[2][3]
        sp = ov[0][4] + ov[1][4] + ov[2][4]
        # a height with NO step rows cannot attribute its wall time to
        # a protocol stage — the unexplained remainder goes to
        # `residual`, not `proposal_wait`, so residual is the honest
        # "no data / decomposition gap" signal rather than a stage
        # that silently absorbs everything
        proposal_wait = (
            max(0, (e1 - t0) - sum(ov[0])) if have_steps else 0
        )
        gossip = max(0, (e2 - e1) - sum(ov[1]))
        apply_ = max(0, (cts - e2) - sum(ov[2]))
        named = proposal_wait + gossip + apply_ + vq + vx + hs + fs + sp
        residual = max(0, dur - named)
        stages_ns = {
            "proposal_wait": proposal_wait,
            "gossip": gossip,
            "verify_queue": vq,
            "verify_execute": vx,
            "hash": hs,
            "spec_exec": sp,
            "wal_fsync": fs,
            "apply": apply_,
            "residual": residual,
        }
        hv = {
            "height": h,
            "node": node,
            "latency_s": round(dur / 1e9, 9),
            "stages": {
                s: round(v / 1e9, 9) for s, v in stages_ns.items()
            },
            "coverage": round((named + residual) / dur, 4),
        }
        if overlapped_fsync or overlapped_spec:
            hv["overlapped"] = {
                "wal_fsync": round(overlapped_fsync / 1e9, 9),
                "spec_exec": round(overlapped_spec / 1e9, 9),
            }
        out[h] = hv
    return out


# budget() memo for the live-ring case: [recorder identity, commit
# tally, result]. sample() runs on every metrics scrape (and health
# tests poll it in tight loops); the per-height decomposition only
# changes when a height CLOSES, so keying the memo on the commit-row
# tally makes every between-commits scrape O(1) instead of a full
# 4096+-slot ring decode. (Overlay rows resolved after a commit carry
# post-commit timestamps, outside every closed window — they cannot
# change a cached view.)
_BUDGET_CACHE: list = [None, -1, None]


def budget(events=None) -> dict:
    """The per-height latency-budget view: ``/debug/budget``'s budget
    body, ``budget.json``'s, and the source of the
    ``height_budget_seconds{stage}`` gauges.  ``events`` defaults to
    the live flight ring (memoized on the ring's commit tally — no new
    commit returns the cached view without re-decoding)."""
    if events is None:
        rec = _REC
        cursor = rec._commits[0]
        if _BUDGET_CACHE[0] is rec and _BUDGET_CACHE[1] == cursor:
            return _BUDGET_CACHE[2]
        evs = rec.dump()
    else:
        rec = None
        evs = events
    per = budget_from_events(evs)
    heights = [per[h] for h in sorted(per)]
    agg = {s: 0.0 for s in BUDGET_STAGES}
    tot = 0.0
    for hv in heights:
        for s in BUDGET_STAGES:
            agg[s] += hv["stages"][s]
        tot += hv["latency_s"]
    out = {
        "commits": len(heights),
        "heights": heights,
        "stages_total_s": {s: round(v, 6) for s, v in agg.items()},
        "stage_fractions": (
            {s: round(v / tot, 4) for s, v in agg.items()}
            if tot > 0
            else None
        ),
        "coverage": (
            round(sum(agg.values()) / tot, 4) if tot > 0 else None
        ),
    }
    if events is None:
        # value slot FIRST: a concurrent reader that matches the key
        # slots below must find the new result, never None/stale
        _BUDGET_CACHE[2] = out
        _BUDGET_CACHE[1] = cursor
        _BUDGET_CACHE[0] = rec
    return out


# ---------------------------------------------------- critical path

# budget stages that are device-plane time — the ``plane`` dimension of
# the critical-path verdict groups them back into their planes
_PLANE_STAGES = {
    "verify": ("verify_queue", "verify_execute"),
    "hash": ("hash",),
}


def critical_path_from_events(events) -> dict[int, dict]:
    """Name, per committed height, the resource that gated the commit.

    Joins three views of the same commit window: the per-height budget
    stage tiles (:func:`budget_from_events` — the coalescer queue waits
    already ride in via the EV_BUDGET overlay rows), the EV_LOCK slow
    lock-wait rows (window-assigned by timestamp, exactly like
    EV_FSYNC), and the device-plane share of the stage tiling.  The
    verdict is ``stage × lock × plane × cpu``: the dominant non-residual
    budget stage, the lock with the largest in-window slow-wait total
    (with the blocking holder's acquire site), the dominant device
    plane, and — when the sampling profiler ran — the subsystem with
    the largest in-window on-CPU time (EV_PROF window rows, so a commit
    gated by GIL-bound Python in the FSM says ``cpu:consensus``, not
    just ``stage:verify_execute``) — ``gate`` names whichever dimension
    explains the most time.  Pure function of the decoded event stream
    (the postmortem timeline merge reuses it for its per-height
    ``critical_path`` rows)."""
    budgets = budget_from_events(events)
    if not budgets:
        return {}
    # commit window anchors (earliest commit row per height, the same
    # anchor budget_from_events uses) + the EV_LOCK wait rows + the
    # EV_PROF profiler window rows
    anchors: dict[int, tuple] = {}
    lock_rows: list[tuple] = []
    prof_rows: list[tuple] = []
    for ev in events:
        name = ev.get("event")
        if name == "consensus.commit":
            h = ev.get("height", 0)
            if h:
                cur = anchors.get(h)
                if cur is None or ev.get("ts", 0) < cur[0]:
                    anchors[h] = (ev.get("ts", 0), ev.get("dur_ns", 0))
        elif name == "sync.lock":
            if ev.get("kind_name") == "wait":
                lock_rows.append((
                    ev.get("ts", 0), ev.get("lock", "?"),
                    ev.get("dur_ns", 0), ev.get("site", "?"),
                ))
        elif name == "prof.window":
            # the profiler's own thread never gates a commit
            if ev.get("subsystem") != "sampler":
                prof_rows.append((
                    ev.get("ts", 0), ev.get("subsystem", "?"),
                    ev.get("oncpu_ns", 0),
                ))
    out: dict[int, dict] = {}
    for h, bud in budgets.items():
        cts, dur = anchors.get(h, (0, 0))
        if dur <= 0:
            continue
        t0 = cts - dur
        stages = bud["stages"]
        # dominant non-residual stage tile
        stage, stage_s = None, -1.0
        for s, v in stages.items():
            if s != "residual" and v > stage_s:
                stage, stage_s = s, v
        stage_s = max(0.0, stage_s)
        # dominant device plane (its stages' combined tile)
        plane, plane_s = None, 0.0
        for p, names in _PLANE_STAGES.items():
            v = 0.0
            for s in names:
                v += stages.get(s, 0.0)
            if v > plane_s:
                plane, plane_s = p, v
        # hottest lock: largest slow-wait total inside the window
        waits: dict[str, float] = {}
        sites: dict[str, str] = {}
        for ts, lk, d, site in lock_rows:
            if t0 <= ts <= cts:
                waits[lk] = waits.get(lk, 0.0) + d / 1e9
                sites.setdefault(lk, site)
        lock, lock_wait_s = None, 0.0
        for lk, v in waits.items():
            if v > lock_wait_s:
                lock, lock_wait_s = lk, v
        # hottest on-CPU subsystem: EV_PROF flush windows are stamped
        # at window END, so a row belongs to the commit window when its
        # flush landed inside it (the per-second granularity matches
        # the ~100 ms-to-seconds commit windows this joins against)
        cpus: dict[str, float] = {}
        for ts, subname, oncpu_ns in prof_rows:
            if t0 <= ts <= cts:
                cpus[subname] = cpus.get(subname, 0.0) + oncpu_ns / 1e9
        cpu, cpu_s = None, 0.0
        for subname, v in cpus.items():
            if v > cpu_s:
                cpu, cpu_s = subname, v
        gate, gate_s = f"stage:{stage}", stage_s
        if lock is not None and lock_wait_s > gate_s:
            gate, gate_s = f"lock:{lock}", lock_wait_s
        if plane is not None and plane_s > gate_s:
            gate, gate_s = f"plane:{plane}", plane_s
        if cpu is not None and cpu_s > gate_s:
            gate, gate_s = f"cpu:{cpu}", cpu_s
        out[h] = {
            "height": h,
            "node": bud.get("node"),
            "latency_s": bud["latency_s"],
            "coverage": bud["coverage"],
            "stage": stage,
            "stage_s": round(stage_s, 6),
            "lock": lock,
            "lock_wait_s": round(lock_wait_s, 6),
            "lock_site": sites.get(lock) if lock else None,
            "plane": plane,
            "plane_s": round(plane_s, 6),
            "cpu": cpu,
            "cpu_s": round(cpu_s, 6),
            "gate": gate,
        }
    return out


def critical_path(events=None) -> dict:
    """The per-height critical-path view: the ``/debug/contention``
    and ``contention.json`` verdict body.  ``events`` defaults to the
    live flight ring."""
    per = critical_path_from_events(
        _REC.dump() if events is None else events
    )
    heights = [per[h] for h in sorted(per)]
    gates: dict[str, int] = {}
    cov = 0.0
    for hv in heights:
        gates[hv["gate"]] = gates.get(hv["gate"], 0) + 1
        cov += hv["coverage"]
    return {
        "commits": len(heights),
        "heights": heights,
        "gates": dict(sorted(gates.items(), key=lambda kv: -kv[1])),
        "coverage": round(cov / len(heights), 4) if heights else None,
    }


def acquire() -> None:
    """Reference-counted enable for node lifecycles (the devstats
    pattern): every booting node acquires, so the recorder is on exactly
    while a node runs — unless ``COMETBFT_TPU_HEALTH=0`` pins it off."""
    global _acquirers, _enabled
    if _env_mode() == "off":
        return
    _acquirers += 1
    _enabled = True


def release() -> None:
    global _acquirers, _enabled
    _acquirers = max(0, _acquirers - 1)
    if _acquirers == 0 and _env_mode() != "on":
        _enabled = False



def record(
    code: int, height: int = 0, round_: int = 0, a: int = 0, b: int = 0
) -> None:
    """Record one flight event.  Allocation-free and lock-free; a
    single flag check when the recorder is off."""
    if not _enabled:
        return
    _REC.record(code, height, round_, a, b)


def recorder() -> FlightRecorder:
    return _REC


def slis() -> dict:
    return _REC.slis()


def note_breaker_trip() -> None:
    """crypto/coalesce hook: the half-open breaker tripped (wedged
    verify executor).  Records the ring event and leaves a notice the
    wedged-coalescer watchdog converts into a trip on its next check.
    Takes no lock — the caller may sit close to engine mutexes."""
    _BREAKER_NOTICES[0] = _BREAKER_NOTICES[0] + 1
    record(EV_BREAKER, a=1)


def note_breaker_rearm() -> None:
    """crypto/coalesce hook: a successful half-open probe re-armed
    routing."""
    record(EV_BREAKER, a=0)



def debug_budget_json() -> str:
    """Body of the pprof server's ``/debug/budget`` route: the
    device-time ledger (per-caller attribution + occupancy +
    reconciliation) and the per-height latency budget."""
    return json.dumps(
        {
            "ledger": libdevledger.snapshot(),
            "budget": budget(),
        },
        default=str,
    )


def debug_contention_json() -> str:
    """Body of the pprof server's ``/debug/contention`` route: the
    per-lock contention ledger (libs/lockprof), the per-height
    critical-path verdicts, and every thread's held/blocked-on lock
    state. ``hot_lock`` is the watchdog's verdict, None until a
    watchdog service runs in the port."""
    return json.dumps(
        {
            "lockprof": liblockprof.snapshot(),
            "critical_path": critical_path(),
            "hot_lock": None,
            "threads": {
                str(tid): info
                for tid, info in libsync.held_locks_snapshot().items()
            },
        },
        default=str,
    )
