"""The port's introspection listeners: libs/service.HTTPService,
libs/pprof.PprofServer and libs/devstats.PrometheusServer, on port 0.

* The pprof server answers 200 on every route it serves, 404 on an
  unknown one and 500 on a bad request, and its generated index lists
  every route; the torch.profiler routes write a trace on the CPU.
* The Prometheus listener's ``/metrics`` body and content type equal the
  reference exporter's for the same registry state.
* Address parsing, ``prometheus_addr`` and devstats' refcount read as
  the reference's.
"""

import json
import types
import urllib.error
import urllib.request

import pytest
import torch

from cometbft_tpu.libs import devstats as ref_devstats
from cometbft_tpu.libs import metrics as ref_metrics
from cometbft_tpu.libs import service as ref_service
from cometbft_tpu_torch.libs import devstats, devledger, pprof, service
from cometbft_tpu_torch.libs import metrics as port_metrics

ROUTES = (
    "/debug/pprof", "/debug/pprof/", "/debug/pprof/goroutine",
    "/debug/pprof/heap", "/debug/heap/start", "/debug/heap/stop",
    "/debug/locks", "/debug/devstats", "/debug/budget", "/debug/flight",
    "/debug/contention", "/debug/trace", "/debug/trace/start",
    "/debug/trace/stop", "/debug/torch/start_trace",
    "/debug/torch/stop_trace",
)


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _status(port: int, path: str) -> int:
    try:
        return _get(port, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture
def pprof_server():
    srv = pprof.PprofServer("tcp://127.0.0.1:0")
    srv.start()
    yield srv
    srv.stop()
    from cometbft_tpu_torch.libs import trace

    trace.disable()


def test_pprof_serves_its_routes_and_refuses_others(pprof_server):
    port = pprof_server.bound_port
    assert set(pprof_server._route_map) == set(ROUTES)
    for path in ROUTES:
        if path.startswith("/debug/torch/"):
            continue  # the round trip below
        assert _status(port, path) == 200, path
    assert _status(port, "/debug/nope") == 404
    assert _status(port, "/debug/health") == 404  # waits for its module
    assert _status(port, "/debug/torch/start_trace") == 500  # no ?dir=
    index = _get(port, "/debug/pprof/")[2]
    for path in ROUTES:
        if path not in ("/debug/pprof", "/debug/pprof/"):
            assert f"\n{path}" in index, path
    for route in ("/debug/budget", "/debug/flight", "/debug/contention",
                  "/debug/devstats", "/debug/locks", "/debug/trace"):
        json.loads(_get(port, route)[2])
    assert "--- thread " in _get(port, "/debug/pprof/goroutine")[2]


def test_torch_trace_round_trip_writes_a_trace(pprof_server, tmp_path):
    port = pprof_server.bound_port
    out = tmp_path / "trace"
    assert _get(port, f"/debug/torch/start_trace?dir={out}")[2] == (
        f"tracing to {out}")
    assert "already active" in _get(
        port, f"/debug/torch/start_trace?dir={out}")[2]
    x = torch.ones(64, 64)
    (x @ x).sum()
    body = _get(port, "/debug/torch/stop_trace")[2]
    assert body.startswith("trace written to ")
    path = body[len("trace written to "):]
    assert path.startswith(str(out))
    assert "traceEvents" in json.loads(open(path).read())
    assert _get(port, "/debug/torch/stop_trace")[2] == "no active trace"


def _registries():
    """The same families, the same observations, in both packages."""
    regs = []
    for lib in (ref_metrics, port_metrics):
        r = lib.Registry()
        c = r.counter("ledger_test_total", "a counter",
                      label_names=("plane", "caller"))
        g = r.gauge("ledger_test_gauge", "a gauge")
        h = r.histogram("ledger_test_seconds", "a histogram",
                        buckets=(0.001, 0.01, 0.1))
        c.labels("verify", "consensus-vote").inc(3)
        c.labels("hash", "merkle").inc(0.5)
        g.set(7)
        for v in (0.0005, 0.02, 3.0):
            h.observe(v)
        regs.append(r)
    return regs


def test_metrics_body_equals_the_reference_exporters():
    servers = []
    for mod, reg in zip((ref_devstats, devstats), _registries()):
        srv = mod.PrometheusServer("127.0.0.1:0", reg)
        srv.start()
        servers.append(srv)
    try:
        ref_body, body = (_get(s.bound_port, "/metrics") for s in servers)
        assert body == ref_body
        assert body[1] == devstats.PrometheusServer.CONTENT_TYPE
        assert "cometbft_tpu_ledger_test_total" in body[2]
        assert _get(servers[1].bound_port, "/") == _get(
            servers[0].bound_port, "/")
        assert _status(servers[1].bound_port, "/nope") == 404
    finally:
        for s in servers:
            s.stop()


def test_metrics_refresh_feeds_the_ledger_lanes():
    """A refresh hook that samples the ledger puts its lanes into the
    scrape (as a node's pull-time hook would)."""
    was = devledger.enabled()
    devledger.enable()
    devledger.reset()
    m = port_metrics.NodeMetrics()
    srv = devstats.PrometheusServer(
        "127.0.0.1:0", m.registry, refresh=lambda: devledger.sample(m))
    srv.start()
    try:
        devledger.note_resolve(devledger.PLANE_VERIFY,
                               devledger.CALLER_CODES["consensus-vote"],
                               5, 0, 10, 0)
        body = _get(srv.bound_port, "/metrics")[2]
        assert ('cometbft_tpu_device_lanes_total{plane="verify",'
                'caller="consensus-vote"} 5.0') in body
        # the self-metric shows from the next scrape on
        body = _get(srv.bound_port, "/metrics")[2]
        assert ('cometbft_tpu_health_scrape_duration_seconds_count'
                '{endpoint="prometheus"} 1') in body
    finally:
        srv.stop()
        devledger.reset()
        devledger.enable() if was else devledger.disable()


@pytest.mark.parametrize("addr", ["tcp://10.1.2.3:26660", ":26661",
                                  "localhost:0"])
def test_addresses_parse_as_the_reference_parses_them(addr):
    ours = service.HTTPService("x", addr)
    ref = ref_service.HTTPService("x", addr)
    assert (ours.host, ours.port) == (ref.host, ref.port)
    assert devstats.PrometheusServer(addr, port_metrics.Registry()).host == (
        ref_devstats.PrometheusServer(addr, ref_metrics.Registry()).host)


def test_prometheus_addr_and_refcount_as_the_reference(monkeypatch):
    cfg = types.SimpleNamespace(instrumentation=types.SimpleNamespace(
        prometheus=True, prometheus_listen_addr=":26660"))
    off = types.SimpleNamespace(instrumentation=types.SimpleNamespace(
        prometheus=False, prometheus_listen_addr=":26660"))
    monkeypatch.delenv("COMETBFT_TPU_PROM_ADDR", raising=False)
    for c in (None, cfg, off):
        assert devstats.prometheus_addr(c) == ref_devstats.prometheus_addr(c)
    monkeypatch.setenv("COMETBFT_TPU_PROM_ADDR", "127.0.0.1:9100")
    assert devstats.prometheus_addr(cfg) == "127.0.0.1:9100"
    monkeypatch.delenv("COMETBFT_TPU_DEVSTATS", raising=False)
    was = devstats.enabled()
    monkeypatch.setattr(devstats, "_acquirers", 0)
    devstats.disable()
    try:
        devstats.acquire()
        devstats.acquire()
        devstats.release()
        assert devstats.enabled()
        devstats.release()
        assert not devstats.enabled()
        snap = devstats.snapshot()
        assert snap["device_ledger"].keys() == devledger.snapshot().keys()
    finally:
        devstats.enable() if was else devstats.disable()
