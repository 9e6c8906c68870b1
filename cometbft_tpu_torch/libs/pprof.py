"""Profiling/introspection HTTP server (reference: the net/http/pprof
server gated by RPC config ``pprof_laddr``), with torch.profiler hooks in
the place of Go's CPU profiles.

Port of cometbft_tpu/libs/pprof.py. Endpoints (all GET, plain text or
JSON):

  /debug/pprof/            index (generated from the routes)
  /debug/pprof/goroutine   every thread's stack (goroutine dump analog)
  /debug/pprof/heap        rss + tracemalloc top allocations
  /debug/heap/start|stop   switch tracemalloc on or off
  /debug/torch/start_trace?dir=PATH   start a torch.profiler trace (the
                                      card's activities when CUDA is
                                      present, the host's always)
  /debug/torch/stop_trace             stop it; the trace is written to
                                      PATH as a Chrome trace
  /debug/locks             deadlock-tier status (libs/sync)
  /debug/contention        per-lock wait/hold profile + critical path
  /debug/devstats          device telemetry snapshot (libs/devstats)
  /debug/budget            device-time ledger + per-height budgets
  /debug/flight            raw flight-ring export (libs/health)
  /debug/trace             libs/trace ring-buffer dump (JSON)
  /debug/trace/start?file=PATH   enable the span tracer (+ optional
                                 JSONL file sink at PATH)
  /debug/trace/stop        disable the tracer and close the file sink

The reference's ``/debug/pprof/profile``, ``/debug/health``,
``/debug/net``, ``/debug/tx`` and ``/debug/timeline`` routes wait for
the modules that produce their bodies (the sampling profiler, the health
watchdog, p2p and transaction telemetry); the server serves only routes
whose bodies exist.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import traceback

from .service import HTTPService


def thread_dump() -> str:
    """All live threads' stacks, the goroutine-dump analog.

    Each header names the thread's subsystem (``?``: the sampling
    profiler that resolves it is not in the port yet), the locks it holds
    and the lock it is blocked on (and for how long), from libs/sync's
    registries, so the dump answers "who is waiting on whom"."""
    import time

    names = {t.ident: t.name for t in threading.enumerate()}
    try:
        from . import sync as libsync

        held = libsync.held_locks_snapshot()
    except Exception:
        held = {}
    now = time.monotonic_ns()
    out = io.StringIO()
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, "?")
        out.write(f"--- thread {tid} ({name}) [?] ---\n")
        info = held.get(tid)
        if info:
            if info.get("held"):
                out.write(f"    holding: {', '.join(info['held'])}\n")
            blocked = info.get("blocked_on")
            if blocked is not None:
                since = info.get("blocked_since_ns")
                if since:
                    wait_s = max(0.0, (now - since) / 1e9)
                    out.write(
                        f"    blocked on: {blocked} (for {wait_s:.3f}s)\n")
                else:
                    out.write(f"    blocked on: {blocked}\n")
        traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


def heap_start() -> str:
    """Enable tracemalloc (interpreter-wide allocation tracking costs
    real time, so a mere scrape never switches it on)."""
    import tracemalloc

    if tracemalloc.is_tracing():
        return "tracemalloc already tracing\n"
    tracemalloc.start()
    return "tracemalloc started\n"


def heap_stop() -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        return "tracemalloc not tracing\n"
    tracemalloc.stop()
    return "tracemalloc stopped\n"


def heap_dump(top: int = 40) -> str:
    """The process's max RSS, plus the top allocation sites when tracing
    was enabled through /debug/heap/start."""
    import resource
    import tracemalloc

    rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    head = f"max rss: {rss_kb / 1024:.1f} MB\n"
    if not tracemalloc.is_tracing():
        return head + (
            "tracemalloc off (enable with /debug/heap/start for "
            "per-site allocation stats)\n"
        )
    snap = tracemalloc.take_snapshot()
    lines = [str(s) for s in snap.statistics("lineno")[:top]]
    total = sum(s.size for s in snap.statistics("filename"))
    return (
        head
        + f"total traced: {total / 1e6:.1f} MB\n"
        + "\n".join(lines)
        + "\n"
    )


class _TorchTrace:
    """The one torch.profiler session a process may have open. The
    profiler is entered and left on a thread of its own, so start and
    stop may come from different request threads; the card's activities
    (kernels, copies) are recorded for every thread of the process."""

    _mtx = threading.Lock()
    active_dir: str | None = None
    _stop: threading.Event | None = None
    _thread: threading.Thread | None = None
    _path: str | None = None
    _error: BaseException | None = None


def start_torch_trace(trace_dir: str) -> str:
    """Start a torch.profiler session that stop_torch_trace writes to
    ``trace_dir`` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = _TorchTrace
    with st._mtx:
        if st.active_dir is not None:
            return f"trace already active at {st.active_dir}"
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        started = threading.Event()
        stop = threading.Event()
        st._path = os.path.join(
            trace_dir, f"torch_trace.{os.getpid()}.json")
        st._error = None

        def run(path=st._path):
            try:
                with profile(activities=activities) as prof:
                    started.set()
                    stop.wait()
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                prof.export_chrome_trace(path)
            except BaseException as e:  # reported by stop_torch_trace
                st._error = e
            finally:
                started.set()

        st._stop = stop
        st._thread = threading.Thread(target=run, name="torch-trace",
                                      daemon=True)
        st._thread.start()
        started.wait()
        if st._error is not None:
            st._thread.join()
            st._thread = st._stop = None
            raise st._error
        st.active_dir = trace_dir
    return f"tracing to {trace_dir}"


def stop_torch_trace() -> str:
    """Stop the session and write its trace; the body names the file."""
    st = _TorchTrace
    with st._mtx:
        if st.active_dir is None:
            return "no active trace"
        st._stop.set()
        st._thread.join()
        st._thread = st._stop = None
        st.active_dir = None
        if st._error is not None:
            raise st._error
        return f"trace written to {st._path}"


# One-line operator docs per route, rendered into the index page. The
# index is generated from the live route map: every registered route
# appears, with its doc line.
ROUTE_DOCS: dict[str, str] = {
    "/debug/pprof/goroutine": "thread stacks",
    "/debug/pprof/heap": "rss + tracemalloc snapshot",
    "/debug/heap/start": "enable tracemalloc",
    "/debug/heap/stop": "disable tracemalloc",
    "/debug/torch/start_trace": "?dir=PATH  start a torch.profiler trace",
    "/debug/torch/stop_trace": "stop it, write PATH's Chrome trace",
    "/debug/locks": "deadlock-tier status",
    "/debug/devstats": "device telemetry (JSON)",
    "/debug/budget": (
        "device-time ledger + per-height latency budgets (JSON)"
    ),
    "/debug/flight": "raw flight-ring export (JSON)",
    "/debug/contention": (
        "per-lock wait/hold profile + per-height critical path (JSON)"
    ),
    "/debug/trace": "span-tracer ring dump",
    "/debug/trace/start": "?file=PATH  enable the span tracer",
    "/debug/trace/stop": "disable the tracer, close the sink",
}


class PprofServer(HTTPService):
    """Threaded HTTP server bound to ``pprof_laddr`` (scaffolding shared
    with the Prometheus exporter through ``libs/service.HTTPService``)."""

    def __init__(self, addr: str, logger=None):
        super().__init__("pprof", addr, logger)
        self._route_map = self._routes()

    def handle_get(self, path: str, query: dict) -> tuple[str, str]:
        fn = self._route_map.get(path)
        if fn is None:
            raise KeyError(path)
        return "text/plain; charset=utf-8", fn(query)

    def index_text(self) -> str:
        """The index body, generated from the registered routes so a new
        route can never be left out of the listing."""
        lines = ["cometbft-tpu pprof"]
        for path in sorted(self._route_map):
            if path in ("/debug/pprof", "/debug/pprof/"):
                continue  # the index's own aliases
            doc = ROUTE_DOCS.get(path, "")
            lines.append(f"{path:<24} {doc}".rstrip())
        return "\n".join(lines) + "\n"

    def _routes(self):
        def index(q):
            return self.index_text()

        def goroutine(q):
            return thread_dump()

        def heap(q):
            return heap_dump(int(q.get("top", ["40"])[0]))

        def heap_on(q):
            return heap_start()

        def heap_off(q):
            return heap_stop()

        def torch_start(q):
            dirs = q.get("dir")
            if not dirs:
                raise ValueError("missing ?dir=")
            return start_torch_trace(dirs[0])

        def torch_stop(q):
            return stop_torch_trace()

        def locks(q):
            from . import sync as libsync

            return json.dumps({
                "deadlock_detection": libsync.enabled(),
                "timeout_s": libsync.DEADLOCK_TIMEOUT,
            })

        def devstats_dump(q):
            from . import devstats as libdevstats

            return libdevstats.debug_devstats_json()

        def budget_dump(q):
            from . import health as libhealth

            return libhealth.debug_budget_json()

        def flight_dump(q):
            from . import health as libhealth

            return json.dumps(libhealth.export_ring(), default=str)

        def contention_dump(q):
            from . import health as libhealth

            return libhealth.debug_contention_json()

        def trace_dump(q):
            from . import trace as libtrace

            out = libtrace.status()
            out["events"] = libtrace.ring_dump()
            return json.dumps(out, default=str)

        def trace_start(q):
            from . import trace as libtrace

            # sink first: a path that cannot be opened answers 500 with
            # tracing still off
            files = q.get("file")
            if files:
                started = libtrace.start_file_sink(files[0])
                libtrace.enable()
                sink = (f"sink started at {files[0]}" if started
                        else "sink already active")
                return f"tracing on; {sink}\n"
            libtrace.enable()
            return "tracing on (ring only)\n"

        def trace_stop(q):
            from . import trace as libtrace

            libtrace.disable()
            closed = libtrace.stop_file_sink()
            return "tracing off" + ("; sink closed\n" if closed else "\n")

        return {
            "/debug/pprof/": index,
            "/debug/pprof": index,
            "/debug/pprof/goroutine": goroutine,
            "/debug/pprof/heap": heap,
            "/debug/heap/start": heap_on,
            "/debug/heap/stop": heap_off,
            "/debug/torch/start_trace": torch_start,
            "/debug/torch/stop_trace": torch_stop,
            "/debug/locks": locks,
            "/debug/devstats": devstats_dump,
            "/debug/budget": budget_dump,
            "/debug/flight": flight_dump,
            "/debug/contention": contention_dump,
            "/debug/trace": trace_dump,
            "/debug/trace/start": trace_start,
            "/debug/trace/stop": trace_stop,
        }
