"""Device-time ledger: who used the shared device planes, and for how long.

Port of cometbft_tpu/libs/devledger.py. The verify coalescer
(crypto/coalesce.py) and the hash plane (crypto/hashplane.py) are
multi-tenant: consensus vote and commit verification, the light client,
PartSet and merkle hashing all coalesce lanes into the same windows.
This module attributes the planes' time, lane share and queue delay to
a caller:

* **Caller classes** — every routed submit carries a caller class
  declared by the OUTERMOST tenant through the :func:`caller_class`
  thread-local: consensus-vote, commit-verify, proposal, light,
  mempool, blocksync, evidence, merkle, or "other" when nobody
  declared. Outermost wins: attribution names the tenant that entered
  the engine, not the mechanism it delegated to.

* **The ledger** — per-(plane, caller) lanes, tickets, queue wait and
  pro-rata window execute/host time accumulate into preallocated
  lock-free ``array('q')`` columns (single-writer-per-plane record
  paths, GIL-atomic scalar stores; a lost increment under a rare
  cross-thread race costs one tally, never a corrupt structure). The
  enabled record path keeps no allocation.

* **Occupancy** — per-plane executor-busy, readback and measured
  readback/execute overlap columns, derived at read time into a busy
  fraction and the drain's overlap efficiency (how much of the readback
  hid under the next window's pack and dispatch).

Times come from the host clock (``time.monotonic_ns`` and the planes'
``perf_counter`` spans): the ledger measures the executor's pack and
dispatch and the drain's readback, not kernel time on the card.

Scrape surface: :func:`sample` bridges the monotone columns into each
scraped registry's ``device_time_seconds_total{plane,caller}`` /
``device_lanes_total{plane,caller}`` counters from per-registry
watermarks; :func:`snapshot` is the ``/debug/budget`` ledger body;
:func:`reconcile` checks that caller-attributed time sums to total
window time (within 1 % for any real burst).

Knobs: ``COMETBFT_TPU_LEDGER`` (auto: on while an acquirer holds it,
refcounted; 1 force; 0 off) and ``COMETBFT_TPU_LEDGER_STARVE_MS``
(the consensus queue-wait p99 threshold a starvation watchdog reads).

No locks: the one shared mutable state is the preallocated column set,
and thread-locals carry the caller declaration.
"""

from __future__ import annotations

import os
import threading
import time
from array import array

_ENV_LEDGER = "COMETBFT_TPU_LEDGER"
_ENV_STARVE_MS = "COMETBFT_TPU_LEDGER_STARVE_MS"

_ON_VALUES = ("1", "on", "true", "yes")
_OFF_VALUES = ("0", "off", "false", "no")

# -- caller classes ------------------------------------------------------
#
# A FIXED enum: the ``caller`` label of every exported family, so the
# cardinality audit can pin its value space.  Index 0 is the
# unattributed default; appending is fine, reordering is not (the
# columns are indexed by these codes).
CALLERS = (
    "other",
    "consensus-vote",
    "commit-verify",
    "proposal",
    "light",
    "mempool",
    "blocksync",
    "evidence",
    "merkle",
)
CALLER_CODES = {name: i for i, name in enumerate(CALLERS)}
N_CALLERS = len(CALLERS)

# -- planes --------------------------------------------------------------
PLANES = ("verify", "hash")
PLANE_VERIFY = 0
PLANE_HASH = 1
N_PLANES = len(PLANES)

# Caller classes whose verify/hash plane time blocks the consensus FSM —
# the share the per-height latency budget (libs/health.budget) charges
# to its verify/hash stages, and the consensus side of the starvation
# watchdog's lane-share test.  Vote admission, the proposal signature
# check and commit verification all run on (or block) the FSM thread;
# merkle (PartSet/header roots) and the mempool's commit-path key batch
# are the hash plane's FSM-adjacent callers (CheckTx key hashing rides
# the same class from RPC/p2p threads — documented approximation).
BUDGET_VERIFY_CALLERS = frozenset(
    CALLER_CODES[c] for c in ("consensus-vote", "commit-verify", "proposal")
)
BUDGET_HASH_CALLERS = frozenset(
    CALLER_CODES[c] for c in ("merkle", "mempool")
)

_TLS = threading.local()


class caller_class:
    """Declare the caller class for routed submits on this thread.

    OUTERMOST wins: a nested declaration (the light service delegating
    into the commit-verify walk, a mempool update batching through the
    merkle-tagged hash helpers) is a no-op, so attribution always names
    the tenant that entered the engine, not the innermost mechanism.
    Unknown names map to "other" rather than raising — a bad tag must
    never break a verify path.

    A plain ``__slots__`` context manager, not a generator-based
    ``@contextmanager``: tag sites sit on per-item hot paths (every
    vote verify, every TxKey, every merkle leaf), and the generator
    frame + wrapper object would roughly double the cost of a small
    host hash just to set one thread-local int.
    """

    __slots__ = ("_cid", "_prev")

    def __init__(self, name: str):
        self._cid = CALLER_CODES.get(name, 0)

    def __enter__(self):
        prev = getattr(_TLS, "cid", 0)
        self._prev = prev
        if prev == 0 and self._cid:
            _TLS.cid = self._cid
        return self

    def __exit__(self, exc_type, exc, tb):
        _TLS.cid = self._prev
        return False


def current_caller() -> int:
    """The caller-class code routed submits on this thread carry."""
    return getattr(_TLS, "cid", 0)


def caller_name(cid: int) -> str:
    return CALLERS[cid] if 0 <= cid < N_CALLERS else "other"


# -- enable gating (the devstats/health refcount pattern) ----------------


def _env_mode() -> str:
    v = os.environ.get(_ENV_LEDGER, "").lower()
    if v in _ON_VALUES:
        return "on"
    if v in _OFF_VALUES:
        return "off"
    return "auto"


def starve_threshold_s() -> float:
    """Consensus queue-wait p99 (seconds) above which the starvation
    watchdog considers consensus starved (default 50 ms)."""
    try:
        return float(os.environ.get(_ENV_STARVE_MS, "")) / 1e3
    except ValueError:
        return 0.050


_enabled: bool = _env_mode() == "on"
_acquirers = 0


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def acquire() -> None:
    """Reference-counted enable: the ledger is on while an acquirer
    holds it, unless ``COMETBFT_TPU_LEDGER=0``."""
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


# -- storage -------------------------------------------------------------
#
# Per-(plane, caller) cells, flat-indexed plane * N_CALLERS + caller.
# All columns preallocated; the record path performs only C-level
# scalar loads/stores and small-int arithmetic.

_N_CELLS = N_PLANES * N_CALLERS

_lanes = array("q", [0] * _N_CELLS)
_tickets = array("q", [0] * _N_CELLS)
_wait_ns = array("q", [0] * _N_CELLS)
_exec_ns = array("q", [0] * _N_CELLS)  # pro-rata device window execute
_host_ns = array("q", [0] * _N_CELLS)  # pro-rata host-fallback time

# per-plane columns
_p_windows = array("q", [0] * N_PLANES)
_p_dev_windows = array("q", [0] * N_PLANES)
_p_window_lanes = array("q", [0] * N_PLANES)
_p_window_ns = array("q", [0] * N_PLANES)  # total window execute time
_p_exec_busy_ns = array("q", [0] * N_PLANES)  # executor pack+dispatch/host
_p_exec_since = array("q", [0] * N_PLANES)  # 0 = executor idle
_p_readback_ns = array("q", [0] * N_PLANES)  # drain materialization time
_p_overlap_ns = array("q", [0] * N_PLANES)  # readback under executor busy
_p_first_ns = array("q", [0] * N_PLANES)  # activity watermarks (monotonic)
_p_last_ns = array("q", [0] * N_PLANES)


def reset() -> None:
    """Zero every column (tests, bench windows)."""
    for col in (
        _lanes, _tickets, _wait_ns, _exec_ns, _host_ns,
        _p_windows, _p_dev_windows, _p_window_lanes, _p_window_ns,
        _p_exec_busy_ns, _p_exec_since, _p_readback_ns, _p_overlap_ns,
        _p_first_ns, _p_last_ns,
    ):
        for i in range(len(col)):
            col[i] = 0


# -- record paths --------------------------------------------------------


def note_resolve(
    plane: int, caller: int, lanes: int, wait_ns: int,
    exec_share_ns: int, host_share_ns: int,
) -> None:
    """One resolved ticket: ``lanes`` verified/hashed for ``caller``
    after ``wait_ns`` in the pending queue, charged pro-rata shares of
    the window's device execute and host-fallback time SEPARATELY —
    a mixed hash window (one bucket launched, one hashed inline) splits
    honestly instead of mislabeling host work as device time.  Called
    by the planes' resolve paths — executor or drain thread, never a
    caller thread."""
    if not _enabled:
        return
    i = plane * N_CALLERS + caller
    _lanes[i] += lanes
    _tickets[i] += 1
    if wait_ns > 0:
        _wait_ns[i] += wait_ns
    if exec_share_ns > 0:
        _exec_ns[i] += exec_share_ns
    if host_share_ns > 0:
        _host_ns[i] += host_share_ns


def note_window(plane: int, lanes: int, device: bool) -> None:
    """One flushed window entering launch (plane-grain counters)."""
    if not _enabled:
        return
    _p_windows[plane] += 1
    _p_window_lanes[plane] += lanes
    if device:
        _p_dev_windows[plane] += 1
    now = time.monotonic_ns()
    if _p_first_ns[plane] == 0:
        _p_first_ns[plane] = now
    _p_last_ns[plane] = now


def note_window_time(plane: int, exec_ns: int) -> None:
    """The window's total execute/fallback duration — the denominator
    the per-caller pro-rata shares must reconcile against."""
    if not _enabled:
        return
    if exec_ns > 0:
        _p_window_ns[plane] += exec_ns
    _p_last_ns[plane] = time.monotonic_ns()


def exec_begin(plane: int) -> None:
    """Executor entered its busy section (pack+dispatch, or the host
    window resolve) — the overlap estimator's busy marker."""
    if not _enabled:
        return
    _p_exec_since[plane] = time.monotonic_ns()


def exec_end(plane: int) -> None:
    """Executor left its busy section; banks the busy duration."""
    if not _enabled:
        return
    since = _p_exec_since[plane]
    if since:
        _p_exec_busy_ns[plane] += time.monotonic_ns() - since
        _p_exec_since[plane] = 0


def exec_busy_ns(plane: int) -> int:
    """Cumulative executor-busy ns (the drain snapshots this around a
    readback to measure overlap)."""
    return _p_exec_busy_ns[plane]


def note_readback(plane: int, t0_ns: int, busy0_ns: int) -> None:
    """One drain-side readback finished: ``t0_ns`` was its
    ``monotonic_ns`` start, ``busy0_ns`` the :func:`exec_busy_ns`
    snapshot taken then.  The overlap credit is the executor-busy time
    that elapsed DURING the readback (banked sections plus a live
    in-progress one), clamped to the readback duration — an estimate,
    exact when the executor's busy sections nest cleanly inside or
    around the readback window, and documented as such."""
    if not _enabled:
        return
    now = time.monotonic_ns()
    dur = now - t0_ns
    if dur <= 0:
        return
    overlap = _p_exec_busy_ns[plane] - busy0_ns
    since = _p_exec_since[plane]
    if since:
        live = now - (since if since > t0_ns else t0_ns)
        if live > 0:
            overlap += live
    if overlap < 0:
        overlap = 0
    elif overlap > dur:
        overlap = dur
    _p_readback_ns[plane] += dur
    _p_overlap_ns[plane] += overlap


# -- read paths (scrape / watchdog / tests) ------------------------------


def cell(plane: int, caller: int) -> dict:
    i = plane * N_CALLERS + caller
    return {
        "lanes": _lanes[i],
        "tickets": _tickets[i],
        "wait_ns": _wait_ns[i],
        "exec_ns": _exec_ns[i],
        "host_ns": _host_ns[i],
    }


def verify_lanes_split() -> tuple[int, int]:
    """(consensus-caller lanes, total lanes) on the verify plane — the
    starvation watchdog's lane-share signal.  Plain loops, no
    comprehension frames (the no-trip check path posture)."""
    cons = 0
    total = 0
    base = PLANE_VERIFY * N_CALLERS
    for c in range(N_CALLERS):
        n = _lanes[base + c]
        total += n
        if c in BUDGET_VERIFY_CALLERS:
            cons += n
    return cons, total


def reconcile() -> dict:
    """Caller-attributed time vs total window time, per plane.

    ``ratio`` is attributed/total (1.0 = perfect); integer pro-rata
    floor division loses at most one nanosecond per ticket, so the
    tier-1 gate pins ``|1 - ratio| <= 0.01`` for any real burst."""
    out = {}
    for p, plane in enumerate(PLANES):
        attributed = 0
        lanes = 0
        base = p * N_CALLERS
        for c in range(N_CALLERS):
            attributed += _exec_ns[base + c] + _host_ns[base + c]
            lanes += _lanes[base + c]
        total = _p_window_ns[p]
        out[plane] = {
            "attributed_ns": attributed,
            "window_ns": total,
            "caller_lanes": lanes,
            "window_lanes": _p_window_lanes[p],
            "ratio": (attributed / total) if total else None,
        }
    return out


def occupancy() -> dict:
    """The device occupancy view, derived from the plane columns:
    busy fraction (executor-busy plus non-overlapped readback over the
    plane's active wall span) and the readback drain's overlap
    efficiency (fraction of d2h time hidden under the next window's
    pack+dispatch)."""
    out = {}
    for p, plane in enumerate(PLANES):
        first, last = _p_first_ns[p], _p_last_ns[p]
        span = last - first
        busy = _p_exec_busy_ns[p] + _p_readback_ns[p] - _p_overlap_ns[p]
        rb = _p_readback_ns[p]
        out[plane] = {
            "windows": _p_windows[p],
            "device_windows": _p_dev_windows[p],
            "window_lanes": _p_window_lanes[p],
            "window_exec_s": round(_p_window_ns[p] / 1e9, 6),
            "executor_busy_s": round(_p_exec_busy_ns[p] / 1e9, 6),
            "readback_s": round(rb / 1e9, 6),
            "overlap_s": round(_p_overlap_ns[p] / 1e9, 6),
            "busy_fraction": (
                round(min(1.0, busy / span), 4) if span > 0 else None
            ),
            "overlap_efficiency": (
                round(_p_overlap_ns[p] / rb, 4) if rb > 0 else None
            ),
            "active_span_s": round(span / 1e9, 6) if span > 0 else 0.0,
        }
    return out


def snapshot() -> dict:
    """The ledger body of ``/debug/budget`` and ``budget.json``."""
    callers: dict[str, dict] = {}
    for p, plane in enumerate(PLANES):
        rows = {}
        for c, name in enumerate(CALLERS):
            i = p * N_CALLERS + c
            if _tickets[i] == 0 and _lanes[i] == 0:
                continue
            rows[name] = {
                "lanes": _lanes[i],
                "tickets": _tickets[i],
                "queue_wait_s": round(_wait_ns[i] / 1e9, 6),
                "execute_s": round(_exec_ns[i] / 1e9, 6),
                "host_s": round(_host_ns[i] / 1e9, 6),
            }
        callers[plane] = rows
    return {
        "enabled": _enabled,
        "callers": callers,
        "occupancy": occupancy(),
        "reconciliation": reconcile(),
    }


def sample(metrics=None) -> None:
    """Bridge the monotone ledger columns into ``metrics``' counter
    families from per-registry watermarks (the devstats replay
    pattern), so every scraped registry sees the full series regardless
    of how many nodes share the process."""
    from . import metrics as libmetrics

    m = metrics if metrics is not None else libmetrics.node_metrics()
    wm = getattr(m, "_devledger_wm", None)
    if wm is None:
        wm = m._devledger_wm = {}
    for p, plane in enumerate(PLANES):
        for c, name in enumerate(CALLERS):
            i = p * N_CALLERS + c
            time_ns = _exec_ns[i] + _host_ns[i]
            lanes = _lanes[i]
            if time_ns == 0 and lanes == 0 and (plane, name) not in wm:
                continue  # never-used cell: keep the scrape sparse
            seen_t, seen_l = wm.get((plane, name), (0, 0))
            if time_ns > seen_t:
                m.device_time.labels(plane, name).inc(
                    (time_ns - seen_t) / 1e9
                )
            if lanes > seen_l:
                m.device_lanes.labels(plane, name).inc(lanes - seen_l)
            wm[(plane, name)] = (time_ns, lanes)
