"""The port's observability libs vs the JAX package's, on the CPU.

libs/metrics.py, trace.py, log.py and devstats.py, and the verify path's
hooks into them (ops/verify.verify_batch and its sharded route,
crypto/batch's verifiers). The same lanes go through both packages with
a NodeMetrics pushed, tracing on and devstats on (the port on
device="cpu", the reference on JAX's CPU backend): a 32-lane batch on
cold arenas, 24 lanes on the same keys (warm), a 4-lane batch below the
host/device cut, and the sharded route on 24 lanes. The phase
histograms' label sets and observation counts, the batch histograms',
and the trace events' names and fields must be equal (seconds and
``dur_ns`` aside). The transfer counters must equal the reference's
where both ship the same bytes and differ by what the port does not
ship where they do not (see the devstats tests). A fresh NodeMetrics'
exposition and the log line format must be byte-identical.
"""

import io
import random

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.libs import devstats as jdevstats
from cometbft_tpu.libs import log as jlog
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu.libs import trace as jtrace
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu.parallel import mesh as jmesh
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.libs import devstats as tdevstats
from cometbft_tpu_torch.libs import log as tlog
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.libs import trace as ttrace
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.parallel import mesh as tmesh

CUT = 8  # host/device cut on both sides: 4 lanes host, 24 and 32 device


def _lanes(n, n_keys, seed, corrupt=()):
    rnd = random.Random(seed)
    seeds = [rnd.randbytes(32) for _ in range(n_keys)]
    pks = [ref.pubkey_from_seed(s) for s in seeds]
    out = ([], [], [])
    for i in range(n):
        m = rnd.randbytes(rnd.randrange(1, 120))
        sig = ref.sign(seeds[i % n_keys], m)
        if i in corrupt:
            sig = sig[:50] + bytes([sig[50] ^ 2]) + sig[51:]
        for col, v in zip(out, (pks[i % n_keys], m, sig)):
            col.append(v)
    return out


def _transfers(c):
    return {k: c[k] for k in ("h2d_ops", "h2d_bytes", "d2h_ops", "d2h_bytes")}


def _run(side, monkeypatch):
    """The scenario on one package: per step the transfer counters' delta,
    then the phase and batch histograms' {labels: observations} and the
    trace records (ts, thread, span ids and dur_ns dropped; the
    reference's xla.compile events too, which the port has no
    counterpart of)."""
    if side == "ref":
        metrics, trace, devstats, batch, keys = (jmetrics, jtrace, jdevstats,
                                                 jbatch, jkeys)
        verify_batch_sharded = jverify._verify_batch_sharded
        # the reference's sharded program is held in test_torch_mesh.py;
        # here only its transfer records count, taken around the call
        monkeypatch.setattr(jmesh, "verify_sharded", lambda a, h, m, c, v: (
            np.ones((c, v), bool) & h.reshape(c, v)))
        device = {}
        sharded_kw = {}
    else:
        metrics, trace, devstats, batch, keys = (tmetrics, ttrace, tdevstats,
                                                 tbatch, tkeys)
        verify_batch_sharded = tverify._verify_batch_sharded
        monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
        device = {"device": "cpu"}
        sharded_kw = {"mesh": tmesh.make_mesh(["cpu"] * 2)}
    monkeypatch.setattr(batch, "HOST_BATCH_THRESHOLD", CUT)
    node = metrics.NodeMetrics()
    metrics.push_node_metrics(node)
    trace.enable()
    trace.reset()
    devstats.enable()
    steps, verdicts = {}, {}
    try:
        for name, lanes in (("cold32", _lanes(32, 8, 1, corrupt={9})),
                            ("warm24", _lanes(24, 8, 1)),
                            ("host4", _lanes(4, 4, 2, corrupt={2}))):
            v = batch.Ed25519BatchVerifier(**device)
            for pk, m, s in zip(*lanes):
                v.add(keys.Ed25519PubKey(pk), m, s)
            before = _transfers(devstats.counters())
            verdicts[name] = v.verify()
            after = _transfers(devstats.counters())
            steps[name] = {k: after[k] - before[k] for k in after}
        before = _transfers(devstats.counters())
        verdicts["sharded24"] = verify_batch_sharded(
            *_lanes(24, 8, 3, corrupt={5}), 2, **sharded_kw)
        after = _transfers(devstats.counters())
        steps["sharded24"] = {k: after[k] - before[k] for k in after}
        records = trace.ring_dump()
    finally:
        devstats.disable()
        trace.disable()
        trace.reset()
        metrics.pop_node_metrics(node)
    hist = {
        fam: {key: child._n for key, child in getattr(node, fam)
              ._children.items()}
        for fam in ("verify_phase_seconds", "verify_batch_seconds")
    }
    events = [{k: v for k, v in r.items()
               if k not in ("ts", "thread", "span", "parent", "dur_ns")}
              for r in records if not r["name"].startswith("xla.")]
    return steps, hist, events, verdicts, node


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {side: _run(side, mp) for side in ("ref", "port")}
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def test_fresh_node_metrics_exposition_equals_the_reference():
    assert tmetrics.NodeMetrics().registry.render() == (
        jmetrics.NodeMetrics().registry.render())


def test_verdicts_equal_the_reference(both):
    """The single-device and host steps verdict for verdict; the sharded
    step (whose reference program is stubbed here) names its lane."""
    ref_v, port_v = both["ref"][3], both["port"][3]
    for name in ("cold32", "warm24", "host4"):
        assert port_v[name][0] == ref_v[name][0], name
        assert list(port_v[name][1]) == list(ref_v[name][1]), name
    assert list(port_v["host4"][1]) == [True, True, False, True]
    assert np.flatnonzero(~np.asarray(port_v["cold32"][1])).tolist() == [9]
    assert np.flatnonzero(~np.asarray(port_v["sharded24"][1])).tolist() == [5]


def test_phase_histograms_equal_the_reference(both):
    """crypto_verify_phase_seconds and crypto_verify_batch_seconds: the same
    label sets, the same observation counts."""
    hist = both["port"][1]
    assert hist == both["ref"][1]
    assert hist["verify_phase_seconds"] == {
        ("pack", "ed25519-tpu"): 3, ("dispatch", "ed25519-tpu"): 3,
        ("readback", "ed25519-tpu"): 2, ("fallback", "ed25519-host"): 1}
    assert hist["verify_batch_seconds"] == {("ed25519-tpu",): 2,
                                            ("ed25519-host",): 1}


def test_trace_events_equal_the_reference(both):
    """verify.* events with the same fields: backend, lanes, the arena's
    disposition (miss, then hit; sharded)."""
    events = both["port"][2]
    assert events == both["ref"][2]
    assert [(e["name"], e.get("arena"), e["lanes"]) for e in events] == [
        ("verify.pack", "miss", 32), ("verify.dispatch", "miss", 32),
        ("verify.readback", "miss", 32),
        ("verify.pack", "hit", 24), ("verify.dispatch", "hit", 24),
        ("verify.readback", "hit", 24),
        ("verify.fallback", None, 4),
        ("verify.pack", "sharded", 24), ("verify.dispatch", "sharded", 24)]
    assert all(e["kind"] == "event" and e["backend"].startswith("ed25519")
               for e in events)


def test_devstats_count_the_reference_bytes_on_the_single_device_route(both):
    """32 lanes (a wire bucket) over 8 new keys: the builder's key rows
    (8 x 32 B), the R|S|-k rows and the uint16 slots (98 B a lane) and
    the bit-packed verdicts (32 / 8 B), as the reference counts them."""
    ours, theirs = both["port"][0], both["ref"][0]
    assert ours["cold32"] == theirs["cold32"] == {
        "h2d_ops": 2, "h2d_bytes": 8 * 32 + 98 * 32, "d2h_ops": 1,
        "d2h_bytes": 4}
    assert ours["host4"] == theirs["host4"] == dict.fromkeys(ours["host4"], 0)


def test_devstats_count_the_lanes_that_cross(both):
    """24 lanes: the reference pads the wire rows to the bucket (32) before
    the copy; the port ships the 24 real lanes and pads only the verdicts.
    The sharded route: the port ships pack_inputs' int32 arrays, 680 B a
    lane, once a shard, and reads back each shard's bools; the reference
    counts its host arrays with the nibbles in int64 and host_ok, 1,193 B
    a lane, in one shipment, and the n verdicts it keeps."""
    ours, theirs = both["port"][0], both["ref"][0]
    assert theirs["warm24"] == {"h2d_ops": 1, "h2d_bytes": 98 * 32,
                                "d2h_ops": 1, "d2h_bytes": 4}
    assert ours["warm24"] == {"h2d_ops": 1, "h2d_bytes": 98 * 24,
                              "d2h_ops": 1, "d2h_bytes": 4}
    assert theirs["sharded24"] == {"h2d_ops": 1, "h2d_bytes": 1193 * 32,
                                   "d2h_ops": 1, "d2h_bytes": 24}
    assert ours["sharded24"] == {"h2d_ops": 2, "h2d_bytes": 680 * 32,
                                 "d2h_ops": 2, "d2h_bytes": 32}


def test_devstats_stay_zero_when_disabled():
    assert not tdevstats.enabled()
    before = tdevstats.counters()
    tverify.verify_batch(*_lanes(8, 8, 4), device="cpu",
                         cache=tverify.PubkeyTableCache("cpu", 16))
    assert tdevstats.counters() == before
    assert tdevstats.sample() == {}


def test_devstats_sample_bridges_into_the_metrics(both):
    """sample() folds the tallies into device_transfer_{bytes,ops}_total
    and the arena's into pubkey_arena_*; no CUDA is initialised here, so
    no device-memory rows."""
    node = tmetrics.NodeMetrics()
    tdevstats.enable()
    try:
        c = tdevstats.counters()
        out = tdevstats.sample(node)
        assert out["device_memory"] == []
        assert node.transfer_bytes.labels("h2d").value() == c["h2d_bytes"]
        assert node.transfer_ops.labels("d2h").value() == c["d2h_ops"]
        tdevstats.sample(node)  # a second scrape adds nothing new
        assert node.transfer_bytes.labels("h2d").value() == c["h2d_bytes"]
        snap = tdevstats.snapshot()
        assert snap["enabled"] and snap["transfers"] == c
    finally:
        tdevstats.disable()


def test_lane_arena_gauges(monkeypatch):
    arena = tverify.LaneArena("cpu")
    for _ in range(3):
        arena.stage("wire", np.zeros((128, 10), np.uint8))
    assert (arena.stages, arena.allocs, arena.reuses) == (3, 2, 1)
    assert arena.resident_bytes() == 2 * 128 * 16
    node = tmetrics.NodeMetrics()
    monkeypatch.setattr(tverify, "_LANE_ARENAS", [arena])
    tdevstats.enable()
    try:
        out = tdevstats.sample(node)["lane_arena"]
    finally:
        tdevstats.disable()
    assert out == {"arenas": 1, "buffers": 2, "resident_bytes": 4096,
                   "stages": 3, "reuses": 1, "allocs": 2}
    assert node.lane_arena_stages.labels("alloc").value() == 2


def test_log_lines_equal_the_reference(monkeypatch):
    lines = {}
    for name, mod in (("ref", jlog), ("port", tlog)):
        monkeypatch.setattr(mod.time, "time", lambda: 1_760_000_000.25)
        sink = io.StringIO()
        logger = mod.Logger(sink, level=mod.INFO).with_module("ops.verify")
        logger.info("verify batch", lanes=24, key=b"\x01\x02", ms=1.5,
                    why="two words")
        logger.debug("hidden")
        logger.set_module_level("ops.verify", mod.ERROR)
        logger.info("silenced")
        logger.error("shard failed", err="boom")
        mod.NopLogger().error("never")
        lines[name] = sink.getvalue()
    assert lines["port"] == lines["ref"]
    assert lines["port"].count("\n") == 2
    assert 'module=ops.verify lanes=24 key=0102 ms=1.500 why="two words"' in (
        lines["port"])
    assert tlog.parse_level("Debug") == tlog.DEBUG


def test_trace_spans_and_file_sink(tmp_path):
    ttrace.enable()
    ttrace.reset()
    path = str(tmp_path / "trace.jsonl")
    try:
        assert ttrace.start_file_sink(path)
        with ttrace.span("outer", h=1) as sp:
            ttrace.event("inner", x=2)
        manual = ttrace.begin("manual", parent=sp)
        manual.end(y=3)
        assert ttrace.stop_file_sink()
        recs = ttrace.ring_dump()
    finally:
        ttrace.disable()
        ttrace.reset()
    assert [(r["kind"], r["name"]) for r in recs] == [
        ("event", "inner"), ("span", "outer"), ("span", "manual")]
    assert recs[0]["span"] == recs[1]["span"] == recs[2]["parent"]
    with open(path) as f:
        assert len(f.read().splitlines()) == 3
    assert ttrace.span("off") is ttrace.NOP_SPAN


def test_mixed_and_sr25519_verifiers_observe_their_phases(monkeypatch):
    """MixedBatchVerifier and Sr25519BatchVerifier label their phases and
    batches as the reference's do (cometbft_tpu/crypto/batch.py: "mixed-"
    and "sr25519-" with "tpu" on the device route, "host" below the cut,
    where the one phase is "fallback")."""
    from cometbft_tpu_torch.crypto import sr25519 as tsr

    minis = [bytes([0x31 + i]) * 32 for i in range(2)]
    seeds = [bytes([0x41 + i]) * 32 for i in range(2)]
    lanes = [(tsr.Sr25519PubKey(tsr.public_from_mini(s)),
              lambda m, s=s: tsr.sign(s, m)) for s in minis]
    lanes += [(tkeys.Ed25519PubKey(ref.pubkey_from_seed(s)),
               lambda m, s=s: ref.sign(s, m)) for s in seeds]
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
    node = tmetrics.NodeMetrics()
    tmetrics.push_node_metrics(node)
    try:
        for cut in (2, 100):  # the device, then the host
            monkeypatch.setattr(tbatch, "HOST_BATCH_THRESHOLD", cut)
            for cls, use in ((tbatch.MixedBatchVerifier, lanes),
                             (tbatch.Sr25519BatchVerifier, lanes[:2])):
                v = cls(device="cpu")
                for pk, sign in use:
                    v.add(pk, b"msg", sign(b"msg"))
                assert v.verify()[0]
    finally:
        tmetrics.pop_node_metrics(node)
    phases = {k: c._n for k, c in node.verify_phase_seconds._children.items()}
    batches = {k: c._n for k, c in node.verify_batch_seconds._children.items()}
    want = {}
    for backend in ("mixed", "sr25519"):
        for phase in ("pack", "dispatch", "readback"):
            want[(phase, backend + "-tpu")] = 1
        want[("fallback", backend + "-host")] = 1
    assert phases == want
    assert batches == {(b + s,): 1 for b in ("mixed", "sr25519")
                       for s in ("-tpu", "-host")}
