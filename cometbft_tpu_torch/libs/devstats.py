"""Device telemetry: the card's side of observability.

* **Transfer accounting.** ops/verify records every host->device shipment
  at the pack edge (:func:`record_h2d`: wire rows, arena slots, builder
  key rows, the sharded route's limb arrays) and every device->host read
  at the readback edge (:func:`record_d2h`: bit-packed verdicts, the
  sharded route's per-shard bools), in bytes as they cross.
* **Device gauges on the metrics path.** :func:`sample` is a pull-time
  collector: ``torch.cuda.memory_stats()`` byte gauges per initialised
  device (``device_memory_bytes{device,kind}``), the pubkey arenas'
  occupancy and lookup, build and eviction counters (``pubkey_arena_*``),
  the lane staging arenas' (``lane_arena_*``), and the transfer
  counters bridged into ``device_transfer_{bytes,ops}_total{direction}``.

The JAX package also counts XLA compiles here (``track`` and its compile
ledger). The port has no counterpart: its kernels build once per process
with nvcc (ops/build.py), so its ``xla_*`` families stay at zero.

* **A scrape endpoint.** :class:`PrometheusServer` (a
  ``libs/service.HTTPService``, like ``libs/pprof.PprofServer``) serves a
  registry's exposition at ``COMETBFT_TPU_PROM_ADDR``, the analog of the
  reference CometBFT's Instrumentation listener (``prometheus_listen_addr``,
  ``:26660``).

* **Zero cost when off.** ``COMETBFT_TPU_DEVSTATS`` unset means every
  entry point is one module-flag check and an immediate return.
* **Never initialises CUDA.** :func:`sample` reads memory statistics only
  when CUDA is already initialised in this process, so a scrape is never
  the thing that first brings the card up.

Knobs: ``COMETBFT_TPU_DEVSTATS`` (1/on/true/yes enables; read at import,
and :func:`acquire` / :func:`release` refcount it for a listener's
lifetime) and ``COMETBFT_TPU_PROM_ADDR`` (scrape listener address).
"""

from __future__ import annotations

import json
import os
import time

from . import accel as libaccel
from . import metrics as libmetrics
from . import sync as libsync
from .service import HTTPService

_ENV_DEVSTATS = "COMETBFT_TPU_DEVSTATS"
_ENV_PROM_ADDR = "COMETBFT_TPU_PROM_ADDR"

_ON_VALUES = ("1", "on", "true", "yes")



def _env_on() -> bool:
    return os.environ.get(_ENV_DEVSTATS, "").lower() in _ON_VALUES


_enabled: bool = _env_on()
_acquirers = 0
# the tallies; never held across a metrics call
_mtx = libsync.Mutex("libs.devstats._mtx")
_c = {"h2d_ops": 0, "h2d_bytes": 0, "d2h_ops": 0, "d2h_bytes": 0}


def enabled() -> bool:
    """The one check hot paths make before any telemetry work."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def acquire() -> None:
    """Reference-counted enable: a Prometheus listener's owner acquires on
    start and releases on stop, so telemetry stays on exactly while
    someone can scrape it."""
    global _acquirers
    _acquirers += 1
    enable()


def release() -> None:
    global _acquirers
    _acquirers = max(0, _acquirers - 1)
    if _acquirers == 0 and not _env_on():
        disable()


def record_h2d(nbytes: int) -> None:
    """One host->device shipment at the pack edge."""
    if not _enabled:
        return
    with _mtx:
        _c["h2d_ops"] += 1
        _c["h2d_bytes"] += int(nbytes)


def record_d2h(nbytes: int) -> None:
    """One device->host read at the readback edge."""
    if not _enabled:
        return
    with _mtx:
        _c["d2h_ops"] += 1
        _c["d2h_bytes"] += int(nbytes)


def counters() -> dict:
    """Copy of the raw process-wide tallies."""
    with _mtx:
        return dict(_c)


def _sample_device_memory(m) -> list[dict]:
    """One row per CUDA device of torch's allocator byte statistics (the
    ``*_bytes.all.current`` and ``.peak`` keys), each also a
    ``device_memory_bytes{device,kind}`` gauge. Empty until CUDA is
    initialised: a scrape never initialises it."""
    if not libaccel.accelerator_backend_live():
        return []
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        dev = str(i)
        row = {"device": dev, "kind": torch.cuda.get_device_name(i)}
        for k, v in stats.items():
            if "_bytes.all." in k and k.endswith((".current", ".peak")):
                row[k] = v
                m.device_memory.labels(dev, k).set(v)
        out.append(row)
    return out


def _bridge_delta(store: dict, key: str, current: int) -> int:
    """Advance the last-seen value of a monotone int and return the delta
    to feed its Prometheus counter. ``store`` is the target NodeMetrics'
    own watermark dict, so two scraped registries each see the full
    series. Caller holds ``_mtx``; the counter inc happens outside it."""
    last = store.get(key, 0)
    store[key] = max(last, current)
    return current - last if current > last else 0


def _sample_arena(m) -> dict:
    """The process-wide pubkey arenas (ops.verify.pubkey_cache, one per
    device), summed."""
    from ..ops import verify as ov

    caches = list(ov._PUBKEY_CACHE.values())
    if not caches:
        return {}
    out = {"devices": [str(c.device) for c in caches]}
    for key in ("capacity", "hits", "misses", "builds", "evictions"):
        out[key] = sum(getattr(c, key) for c in caches)
    out["slots_used"] = sum(len(c._slots) for c in caches)
    m.arena_slots.labels("used").set(out["slots_used"])
    m.arena_slots.labels("capacity").set(out["capacity"])
    with _mtx:
        store = m.__dict__.setdefault("_devstats_bridge", {})
        deltas = {k: _bridge_delta(store, k, out[k])
                  for k in ("hits", "misses", "builds", "evictions")}
    if deltas["hits"]:
        m.arena_lookups.labels("hit").inc(deltas["hits"])
    if deltas["misses"]:
        m.arena_lookups.labels("miss").inc(deltas["misses"])
    if deltas["builds"]:
        m.arena_builds.inc(deltas["builds"])
    if deltas["evictions"]:
        m.arena_evictions.inc(deltas["evictions"])
    return out


def _sample_lane_arena(m) -> dict:
    """Every live ops.verify.LaneArena (one per verify coalescer), summed:
    buffers held, their bytes, and stages by outcome (reuse of a slot, or
    the one-time alloc of one)."""
    from ..ops import verify as ov

    arenas = list(ov._LANE_ARENAS)
    if not arenas:
        return {}
    out = {"arenas": len(arenas),
           "buffers": sum(a.buffers() for a in arenas),
           "resident_bytes": sum(a.resident_bytes() for a in arenas),
           "stages": sum(a.stages for a in arenas),
           "reuses": sum(a.reuses for a in arenas),
           "allocs": sum(a.allocs for a in arenas)}
    m.lane_arena_staging.labels("buffers").set(out["buffers"])
    m.lane_arena_staging.labels("resident_bytes").set(out["resident_bytes"])
    with _mtx:
        store = m.__dict__.setdefault("_devstats_bridge", {})
        reuse_d = _bridge_delta(store, "lane_reuses", out["reuses"])
        alloc_d = _bridge_delta(store, "lane_allocs", out["allocs"])
    if reuse_d:
        m.lane_arena_stages.labels("reuse").inc(reuse_d)
    if alloc_d:
        m.lane_arena_stages.labels("alloc").inc(alloc_d)
    return out


def _bridge_transfers(m) -> None:
    """Per-registry catch-up of the transfer tallies."""
    with _mtx:
        store = m.__dict__.setdefault("_devstats_bridge", {})
        deltas = {k: _bridge_delta(store, k, _c[k]) for k in _c}
    for direction in ("h2d", "d2h"):
        if deltas[direction + "_bytes"]:
            m.transfer_bytes.labels(direction).inc(
                deltas[direction + "_bytes"])
        if deltas[direction + "_ops"]:
            m.transfer_ops.labels(direction).inc(deltas[direction + "_ops"])


def sample(metrics=None) -> dict:
    """Pull-time collector: device memory, arena gauges and the transfer
    counters into ``metrics`` (a NodeMetrics; by default the process-wide
    node_metrics() top). No-op when disabled."""
    if not _enabled:
        return {}
    m = metrics if metrics is not None else libmetrics.node_metrics()
    _bridge_transfers(m)
    return {
        "device_memory": _sample_device_memory(m),
        "pubkey_arena": _sample_arena(m),
        "lane_arena": _sample_lane_arena(m),
    }


def snapshot() -> dict:
    """The /debug/devstats JSON: the tallies, the device-time ledger and a
    live sample, one dict."""
    return {
        "enabled": _enabled,
        "transfers": counters(),
        # who used the device: the per-(plane, caller) time/lane ledger
        # and its occupancy view (libs/devledger; the full budget plane
        # is /debug/budget)
        "device_ledger": _ledger_block(),
        **sample(),
    }


def _ledger_block() -> dict:
    try:
        from . import devledger as libdevledger

        return libdevledger.snapshot()
    except Exception as e:  # a ledger fault must not sink the snapshot
        return {"error": repr(e)}


# --------------------------------------------------------- scrape server


def prometheus_addr(config=None) -> str:
    """The scrape listener address: COMETBFT_TPU_PROM_ADDR wins, then a
    config-like object's ``instrumentation`` section (``prometheus``,
    ``prometheus_listen_addr``), else "" (no listener)."""
    addr = os.environ.get(_ENV_PROM_ADDR, "")
    if addr:
        return addr
    if config is not None and config.instrumentation.prometheus:
        return config.instrumentation.prometheus_listen_addr
    return ""


class PrometheusServer(HTTPService):
    """Dedicated /metrics listener (the reference CometBFT's
    Instrumentation server): serves ``registry.render()`` with the
    exposition content type; ``refresh`` (a pull-time gauge hook, such as
    one that runs :func:`sample`) runs before each render."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
    # a scrape target binds all interfaces on its ":26660" default, not
    # loopback like the debug servers
    DEFAULT_HOST = "0.0.0.0"

    def __init__(self, addr: str, registry, refresh=None, logger=None):
        super().__init__("prometheus", addr, logger)
        self.registry = registry
        self._refresh = refresh
        # the scrape self-metric (one shared family definition, so the
        # NodeMetrics registration and this one are the same instance)
        self._scrape_hist = libmetrics.scrape_duration_histogram(registry)

    def handle_get(self, path: str, query: dict) -> tuple[str, str]:
        if path == "/":
            return (
                "text/plain; charset=utf-8",
                "cometbft-tpu prometheus exporter\n"
                "/metrics  registry exposition\n",
            )
        if path != "/metrics":
            raise KeyError(path)
        t0 = time.perf_counter()
        if self._refresh is not None:
            try:
                self._refresh()
            except Exception as e:
                # pull-time gauges are best-effort; the counters and
                # histograms must still scrape
                if self.logger is not None:
                    self.logger.error(
                        "metrics refresh failed", err=repr(e)[:200])
        body = self.registry.render()
        # observed after the render, so it shows from the next scrape on
        # (the usual exporter trade)
        self._scrape_hist.labels("prometheus").observe(
            time.perf_counter() - t0)
        return self.CONTENT_TYPE, body


def debug_devstats_json() -> str:
    """Body of the pprof server's /debug/devstats route."""
    t0 = time.perf_counter()
    body = json.dumps(snapshot(), default=str)
    libmetrics.node_metrics().health_scrape_seconds.labels(
        "devstats").observe(time.perf_counter() - t0)
    return body
