"""Lock-contention profiler: per-lock wait/hold accounting by registry slot.

Port of cometbft_tpu/libs/lockprof.py. The sync tier's sanitizers prove
the locking correct (acyclic order, guards held); this module measures
what the locks cost. Every named mutex/RLock built through the
``libs/sync`` factories records, per lockorder.json registry name, how
often an acquire had to wait, for how long, and how long the lock was
then held.

* **Slots** — the value space is the lockorder.json registry shipped in
  the package (``devtools/lint/graph``, the reference's file copied as
  data): its lock names, sorted, plus one trailing ``other`` slot for
  unregistered names. Bounded by construction, so the ``lock`` metric
  label is audited against the same file the sanitizers read.

* **Columns** — acquires, contended acquires, wait-ns, hold-ns and a
  per-slot wait histogram accumulate into preallocated lock-free
  ``array('q')`` columns (single-scalar GIL-atomic stores; a lost
  increment under a rare cross-thread race costs one tally, never a
  corrupt structure). The enabled record path allocates nothing it keeps
  and takes no lock.

* **Slow path** — a wait or hold past ``COMETBFT_TPU_LOCKPROF_SLOW_MS``
  emits an EV_LOCK flight-ring row (libs/health) carrying the lock slot,
  the duration and the holder's interned acquire site, so the ring names
  the blocker, not just the victim. Site interning allocates — slow path
  only, never per acquire.

Scrape surface: :func:`sample` bridges the monotone columns into each
scraped registry's ``lock_wait_seconds_total{lock}`` /
``lock_hold_seconds_total{lock}`` / ``lock_contended_acquires_total{lock}``
counters from per-registry watermarks; :func:`snapshot` is the
``/debug/contention`` body; :func:`worst_windowed_p99` is the windowed
p99 signal a watchdog reads.

Knobs: ``COMETBFT_TPU_LOCKPROF`` (auto: on while an acquirer holds it,
refcounted; 1 force; 0 off — the kill switch makes the sync factories
hand out raw ``threading`` primitives again) and
``COMETBFT_TPU_LOCKPROF_SLOW_MS`` (slow wait/hold threshold, default 50).

This module imports nothing of the sync/health layers at module level
(sync imports it to wire the profiled lock tier; health imports it to
decode EV_LOCK rows); the one upward call, EV_LOCK emission, imports
health lazily on the slow path. Its one lock (``_sites_mtx``, a raw
``threading.Lock``) serializes slow-path site interning only.
"""

from __future__ import annotations

import json
import os
import threading
from array import array

_ENV_LOCKPROF = "COMETBFT_TPU_LOCKPROF"
_ENV_SLOW_MS = "COMETBFT_TPU_LOCKPROF_SLOW_MS"

_ON_VALUES = ("1", "on", "true", "yes")
_OFF_VALUES = ("0", "off", "false", "no")

# EV_LOCK kind codes (the low bit of the ring row's b column)
KIND_WAIT = 0
KIND_HOLD = 1
KIND_NAMES = {KIND_WAIT: "wait", KIND_HOLD: "hold"}


def _env_mode() -> str:
    v = os.environ.get(_ENV_LOCKPROF, "").lower()
    if v in _ON_VALUES:
        return "on"
    if v in _OFF_VALUES:
        return "off"
    return "auto"


def slow_threshold_s() -> float:
    """Wait/hold duration (seconds) above which an acquire/release emits
    an EV_LOCK ring row (default 50 ms)."""
    try:
        return float(os.environ.get(_ENV_SLOW_MS, "")) / 1e3
    except ValueError:
        return 0.050


# -- registry slots ------------------------------------------------------


def _registry_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "devtools", "lint", "graph", "lockorder.json",
    )


def _load_registry_names() -> tuple[str, ...]:
    try:
        with open(_registry_path(), encoding="utf-8") as f:
            data = json.load(f)
        return tuple(sorted(lk["name"] for lk in data.get("locks", [])))
    except Exception:
        return ()


_REGISTRY = _load_registry_names()
N_SLOTS = len(_REGISTRY)  # registered slots; OTHER_SLOT sits past them
OTHER_SLOT = N_SLOTS
NAMES = _REGISTRY + ("other",)
_SLOT_OF = {name: i for i, name in enumerate(_REGISTRY)}


def slot_for(name: str) -> int:
    """Registry slot of a lock name ("other" for unregistered names),
    resolved once at lock construction, never on the record path."""
    return _SLOT_OF.get(name, OTHER_SLOT)


def slot_name(slot: int) -> str:
    return NAMES[slot] if 0 <= slot < len(NAMES) else "other"


# -- enable gating (refcounted like devledger and health) ----------------

_enabled: bool = _env_mode() == "on"
_acquirers = 0
_slow_ns = max(0, int(slow_threshold_s() * 1e9))


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled, _slow_ns
    _slow_ns = max(0, int(slow_threshold_s() * 1e9))
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def set_slow_ms(ms: float) -> None:
    """Programmatic analog of ``COMETBFT_TPU_LOCKPROF_SLOW_MS``; takes
    effect immediately."""
    global _slow_ns
    _slow_ns = max(0, int(ms * 1e6))


def acquire() -> None:
    """Reference-counted enable: the profiler is on while an acquirer
    holds it, unless ``COMETBFT_TPU_LOCKPROF=0``."""
    global _acquirers, _enabled, _slow_ns
    if _env_mode() == "off":
        return
    _acquirers += 1
    _slow_ns = max(0, int(slow_threshold_s() * 1e9))
    _enabled = True


def release() -> None:
    global _acquirers, _enabled
    _acquirers = max(0, _acquirers - 1)
    if _acquirers == 0 and _env_mode() != "on":
        _enabled = False


# -- storage -------------------------------------------------------------
#
# Flat preallocated columns indexed by registry slot. The wait histogram
# gives a windowed p99 (delta buckets) instead of a mean that one outlier
# hides in; bounds are ns, straddling the 50 ms default threshold.

BUCKET_NS = (
    1_000_000,  # 1 ms
    5_000_000,
    10_000_000,
    25_000_000,
    50_000_000,
    100_000_000,
    250_000_000,
    500_000_000,
    1_000_000_000,  # 1 s
)
N_BUCKETS = len(BUCKET_NS) + 1  # + overflow

_N_CELLS = N_SLOTS + 1  # + the "other" slot

_acquires = array("q", [0] * _N_CELLS)
_contended = array("q", [0] * _N_CELLS)
_wait_ns = array("q", [0] * _N_CELLS)
_hold_ns = array("q", [0] * _N_CELLS)
_hist = array("q", [0] * (_N_CELLS * N_BUCKETS))

# slow-path holder-site intern table (EV_LOCK's b column carries
# ``site_idx * 2 + kind``); index 0 is the unknown site
_SITES: list[str] = ["?"]
_SITE_IDX: dict[str, int] = {"?": 0}
# the profiler's own lock must not route through the sync factories it
# instruments (recursion); it serializes slow-path interning only
_sites_mtx = threading.Lock()


def reset() -> None:
    """Zero every column. The site table is append-only interning and
    survives: indices in rows already recorded must keep decoding."""
    for col in (_acquires, _contended, _wait_ns, _hold_ns, _hist):
        for i in range(len(col)):
            col[i] = 0


# -- record helpers (called from the libs/sync profiled tier) ------------


def note_contended(slot: int, wait_ns: int) -> None:
    """One acquire that had to block for ``wait_ns``: plain column stores
    plus a bounded bucket scan, no allocation, no lock."""
    _contended[slot] += 1
    if wait_ns > 0:
        _wait_ns[slot] += wait_ns
    base = slot * N_BUCKETS
    k = 0
    for bound in BUCKET_NS:
        if wait_ns <= bound:
            break
        k += 1
    _hist[base + k] += 1


def intern_site(site: str) -> int:
    """Slow path only: intern a "file:line" holder site -> index."""
    idx = _SITE_IDX.get(site)
    if idx is None:
        with _sites_mtx:
            idx = _SITE_IDX.get(site)
            if idx is None:
                idx = len(_SITES)
                _SITES.append(site)
                _SITE_IDX[site] = idx
    return idx


def site_name(idx: int) -> str:
    sites = _SITES
    return sites[idx] if 0 <= idx < len(sites) else "?"


def note_slow(slot: int, kind: int, dur_ns: int, site: str) -> None:
    """A wait or hold crossed the slow threshold: emit the EV_LOCK ring
    row naming the lock, the duration and the holder's acquire site.
    Swallows every failure: this runs inside lock acquire/release, and a
    telemetry fault raised there would leave the caller's lock state
    corrupt."""
    try:
        from . import health  # lazy: health imports this module at top

        health.record(
            health.EV_LOCK, 0, slot, dur_ns, intern_site(site) * 2 + kind
        )
    except Exception:
        pass


def slow_ns() -> int:
    """The live slow threshold in ns."""
    return _slow_ns


# -- read paths (scrape / watchdog / debug) ------------------------------


def counts(slot: int) -> dict:
    return {
        "acquires": _acquires[slot],
        "contended": _contended[slot],
        "wait_ns": _wait_ns[slot],
        "hold_ns": _hold_ns[slot],
    }


def _hist_p99(counts_row: list, total: int) -> float:
    """Upper-bound p99 (seconds) of one slot's bucket counts."""
    target = total - total // 100
    seen = 0
    for k in range(N_BUCKETS):
        seen += counts_row[k]
        if seen >= target:
            if k < len(BUCKET_NS):
                return BUCKET_NS[k] / 1e9
            return 2 * BUCKET_NS[-1] / 1e9
    return 0.0


def wait_p99_s(slot: int) -> float | None:
    """Cumulative (not windowed) p99 wait of one slot."""
    base = slot * N_BUCKETS
    row = [0] * N_BUCKETS
    total = 0
    for k in range(N_BUCKETS):
        row[k] = _hist[base + k]
        total += row[k]
    if total == 0:
        return None
    return _hist_p99(row, total)


def worst_windowed_p99(prev: array) -> tuple[int, float]:
    """Per REGISTERED slot, the p99 wait of the contended acquires seen
    since the last call (bucket deltas against ``prev``, a caller-owned
    ``array('q')`` of ``N_SLOTS * N_BUCKETS`` watermarks, updated in
    place). Returns ``(slot, p99_s)`` of the worst lock this window, or
    ``(-1, 0.0)`` when no registered lock saw a contended acquire."""
    worst_slot = -1
    worst_p99 = 0.0
    row = [0] * N_BUCKETS
    for slot in range(N_SLOTS):  # "other" is not an engine lock
        base = slot * N_BUCKETS
        total = 0
        for k in range(N_BUCKETS):
            cur = _hist[base + k]
            row[k] = cur - prev[base + k]
            prev[base + k] = cur
            total += row[k]
        if total <= 0:
            continue
        p99 = _hist_p99(row, total)
        if p99 > worst_p99:
            worst_p99 = p99
            worst_slot = slot
    return (worst_slot, worst_p99)


def snapshot() -> dict:
    """The per-lock body of ``/debug/contention``: every slot that saw an
    acquire, with derived seconds and the cumulative p99 wait; ``hottest``
    names the lock with the largest total wait."""
    locks: dict[str, dict] = {}
    hottest = None
    hottest_wait = 0
    total_wait = 0
    total_hold = 0
    for slot in range(_N_CELLS):
        acq = _acquires[slot]
        cont = _contended[slot]
        if acq == 0 and cont == 0:
            continue
        w = _wait_ns[slot]
        h = _hold_ns[slot]
        total_wait += w
        total_hold += h
        if w > hottest_wait:
            hottest_wait = w
            hottest = NAMES[slot]
        locks[NAMES[slot]] = {
            "acquires": acq,
            "contended": cont,
            "wait_s": round(w / 1e9, 6),
            "hold_s": round(h / 1e9, 6),
            "wait_p99_s": wait_p99_s(slot),
        }
    return {
        "enabled": _enabled,
        "slow_threshold_s": round(_slow_ns / 1e9, 6),
        "registered_locks": N_SLOTS,
        "locks": locks,
        "hottest": hottest,
        "total_wait_s": round(total_wait / 1e9, 6),
        "total_hold_s": round(total_hold / 1e9, 6),
    }


def sample(metrics=None) -> None:
    """Bridge the monotone columns into ``metrics``' counter families
    from per-registry watermarks. The "other" slot is not exported: the
    ``lock`` label stays bounded by the registry."""
    from . import metrics as libmetrics

    m = metrics if metrics is not None else libmetrics.node_metrics()
    wm = getattr(m, "_lockprof_wm", None)
    if wm is None:
        wm = m._lockprof_wm = {}
    for slot in range(N_SLOTS):
        w = _wait_ns[slot]
        h = _hold_ns[slot]
        c = _contended[slot]
        if w == 0 and h == 0 and c == 0 and slot not in wm:
            continue  # never-contended slot: keep the scrape sparse
        seen_w, seen_h, seen_c = wm.get(slot, (0, 0, 0))
        name = NAMES[slot]
        if w > seen_w:
            m.lock_wait.labels(name).inc((w - seen_w) / 1e9)
        if h > seen_h:
            m.lock_hold.labels(name).inc((h - seen_h) / 1e9)
        if c > seen_c:
            m.lock_contended.labels(name).inc(c - seen_c)
        wm[slot] = (w, h, c)
