"""chip_smoke.py's own copy of the ZIP-215 conformance corpus, the
shapes its X4 check compares, and the vote phase's bookkeeping: the
window record, the lane check of the vote path and the sweep's crossing.

The smoke script may import neither tests/ nor cometbft_tpu, so it builds
the ZIP-215 equivalence classes itself with the port's ed25519_ref and
runs them through K1-K4 on the card. Its list must stay equal to
tests/test_zip215_conformance.py::build_corpus, vector for vector.
"""

import importlib.util
from pathlib import Path

import pytest

from cometbft_tpu_torch.crypto import hashplane
from cometbft_tpu_torch.ops import sha256
from test_zip215_conformance import build_corpus


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_corpus_equals_the_conformance_corpus():
    ours = _chip_smoke().zip215_corpus()
    theirs = build_corpus()
    assert [v[0] for v in ours] == [v[0] for v in theirs]
    assert ours == theirs
    assert sum(v[4] for v in ours) == 25  # accepted vectors


def test_x4_check_covers_every_shape_the_hash_path_launches():
    """The X4 check compares each shape once: the padding edges, the fuzz
    and every (block bucket, lane bucket) of X4_PATH_SHAPES. Those cover
    the hash path: merkle leaves of 32-byte keys (1 block) and inner nodes
    (2), the 2,048-byte tx keys (64), in windows of at most 2,048 lanes;
    the 336 part leaves and gossip windows of up to 8 leaves (2,048)."""
    cs = _chip_smoke()
    txs, data = cs.make_hash_block()
    leaves = [b"\x00" + data[i : i + 65536] for i in range(0, len(data), 65536)]
    assert len(txs) == 10_752 and len(leaves) == 336
    shapes = []
    for msgs in cs._x4_inputs(leaves, txs):
        blocks, _ = sha256.pack_messages(msgs)
        shapes.append((blocks.shape[0], blocks.shape[2]))
    assert len(set(shapes)) == len(shapes) == len(cs.X4_PATH_SHAPES) + 2
    assert set(cs.X4_PATH_SHAPES) <= set(shapes)
    bucket = [sha256.block_bucket(sha256.n_blocks(n))
              for n in (1 + 32, 1 + 64, cs.TX_BYTES, 1 + 65536)]
    assert bucket == [1, 2, 64, 2048]
    assert cs.X4_LANE_BUCKETS[-1] == hashplane._DEFAULT_MAX_LANES
    assert sha256.lane_bucket(len(leaves)) == 512
    assert sha256.lane_bucket(cs.INGRESS_THREADS) == 8


def test_plain_x4_step_loop_equals_sha256_plain_and_hashlib():
    """The per-block loop that the card replays from a CUDA graph, run
    step by step on the CPU: equal to sha256_plain and to hashlib on the
    padding edges and on ragged lanes (1 to 5 blocks), and to
    sha256_plain on a wire whose block counts run past the bucket in
    front of random words. check_plain_x4 refuses a state that differs."""
    import hashlib

    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import cuda_sha256

    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    msgs = [rng.bytes(n) for n in cs.PADDING_EDGES] + [
        rng.bytes(int(n)) for n in rng.integers(0, 300, 19)]
    blocks, nblocks = sha256.pack_messages(msgs)
    b, nb = torch.from_numpy(blocks), torch.from_numpy(nblocks)
    state = cs.check_plain_x4(torch, b, nb, "the CPU wire")
    assert sha256._digests_from_state(state.numpy(), len(msgs)) == [
        hashlib.sha256(m).digest() for m in msgs]

    bb, lanes = blocks.shape[0], blocks.shape[2]
    room = rng.integers(0, 2**32, (bb + 8, 16, lanes), dtype=np.uint32)
    room[:bb] = blocks
    over = nblocks.copy()
    over[::3] = bb + 1 + np.arange(len(over[::3])) % 8
    cs.check_plain_x4(torch, torch.from_numpy(room)[:bb],
                      torch.from_numpy(over), "the over-bucket wire")

    real = cs.plain_x4
    cs.plain_x4 = lambda torch_, bl, n: torch.zeros_like(real(torch_, bl, n))
    with pytest.raises(RuntimeError, match="plain_x4 != sha256_plain"):
        cs.check_plain_x4(torch, b, nb, "a broken helper",
                          sha256.sha256_plain(b, nb))
    assert cuda_sha256.as_int64(state).shape == (8, lanes)


# cuobjdump -sass lines of X4 as the H100's toolkit prints them (register
# numbers and encodings abridged), and a loop closed by a backward branch
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_19x4_sha256ItEEvPKjPKT_Pjiij
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   SHF.R.W.U32 R25, R10, 0x16, R10.reuse ;
        /*0020*/                   SHF.L.W.U32.HI R6, R4, 0x1a, R4 ;
        /*0030*/                   SHF.R.U32.HI R8, RZ, 0x3, R4 ;
        /*0040*/                   SHF.R.W.U32 R9, R11, 0x12, R11.reuse ;
        /*0050*/                   IMAD R7, R7, c[0x0][0x390], R6 ;
        /*0060*/                   LDS.128 R12, [R3] ;
        /*0070*/              @!P0 BRA `(.L_x_1) ;
        /*0080*/                   EXIT ;
		Function : other
        /*0000*/                   EXIT ;
"""


def test_sass_report_sides_rotations_by_amount(monkeypatch):
    """The SASS counts X4's rows in PERF.md read: a funnel shift of a
    register with itself is a rotation whatever its direction or reuse
    flag (rotr 22 and 6 are the rounds', rotr 18 and a shift right by 3
    the schedule's), and a backward branch closes a loop."""
    cs = _chip_smoke()
    from cometbft_tpu_torch.ops import build

    monkeypatch.setattr(build, "nvcc_path", lambda: "/nowhere/bin/nvcc")
    monkeypatch.setattr(cs.subprocess, "run",
                        lambda *a, **k: type("P", (), {"stdout": SASS})())
    (name, report), = cs.sass_report("lib.so", "x4_sha256").items()
    assert "x4_sha256It" in name
    assert report["shf_by_side"] == {"round": 2, "schedule": 2}
    (loop,) = report["loops"]
    assert (loop["from"], loop["to"], loop["instructions"]) == (16, 112, 7)
    assert (loop["lds"], loop["opcodes"]["IMAD"]) == (1, 1)


def _x1_sass():
    """An X1-like listing: a loop of 64-bit multiply-adds (three chained
    through R4:R5, 37 on their own, then an add of the result) and a loop
    with a shuffle feeding two multiply-adds and a store."""
    lines = ["\t\tFunction : x1_build_tables",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
             ".L_x_1:"]
    body = ["IMAD.WIDE.U32 R4, R10, R11, R4"] * 3
    body += [f"IMAD.WIDE.U32 R{20 + 2 * k}, R10, R11, RZ" for k in range(37)]
    body += ["IADD3 R6, R4, R5, RZ", "@!P0 BRA `(.L_x_1)",
             "SHFL.IDX PT, R30, R6, R7, 0x1c1f", "IMAD R31, R30, R30, RZ",
             "IMAD R32, R31, R31, RZ", "STG.E desc[UR4][R2.64], R32",
             "@!P1 BRA `(.L_x_2)", "EXIT"]
    for i, ins in enumerate(body, start=1):
        if ins.startswith("SHFL"):
            lines.append(".L_x_2:")
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;")
    return "\n".join(lines) + "\n"


def test_x1_chain_bound_reads_register_dependences(monkeypatch):
    """X1's chain bound in PERF.md: a SASS loop's longest chain follows the
    registers an instruction writes and reads (a .WIDE pair, a .64
    address, predicates), each step priced at its opcode's latency, and
    one warp's issue of a turn is the busier of the FMA pipe and the rest;
    273 squaring turns and 15 table turns over the clock."""
    cs = _chip_smoke()
    from cometbft_tpu_torch.ops import build

    assert cs._dests_sources("IMAD.WIDE.U32", "R4, R6, R7, R4") == (
        ["R4", "R5"], ["R6", "R7", "R4", "R5"])
    assert cs._dests_sources("IADD3", "R4, P0, PT, R6, R7, RZ") == (
        ["R4", "P0"], ["R6", "R7"])
    assert cs._dests_sources("IADD3.X", "R5, R6, R7, RZ, P0, !PT") == (
        ["R5"], ["R6", "R7", "P0"])
    assert cs._dests_sources("SHFL.IDX", "PT, R5, R4, R3, 0x1c1f") == (
        ["R5"], ["R4", "R3"])
    assert cs._dests_sources("ISETP.GE.AND", "P0, PT, R2, R3, PT") == (
        ["P0"], ["R2", "R3"])
    assert cs._dests_sources("STS.128", "[R3], R8") == (
        [], ["R3", "R8", "R9", "R10", "R11"])
    monkeypatch.setattr(build, "nvcc_path", lambda: "/nowhere/bin/nvcc")
    monkeypatch.setattr(cs.subprocess, "run",
                        lambda *a, **k: type("P", (), {"stdout": _x1_sass()})())
    probe = {"latency_cycles": 5.0, "latency_cycles_imad_adds": 4.0,
             "latency_cycles_imad_wide": 10.0, "clock_ghz": 2.0,
             "issue_cycles": {"shf": 2.0, "lop3": 3.0, "iadd3": 2.0,
                              "imad": 2.0, "imad_wide": 6.0}}
    sass = cs.x1_sass("lib.so", probe)
    sq, table = sass["squaring"], sass["table_loop"]
    assert sass["squaring_loops"] == 1
    assert (sq["instructions"], sq["imad_wide"], sq["depth"]) == (42, 40, 4)
    assert sq["chain_cycles"] == 3 * 10.0 + 5.0
    assert sq["issue_cycles"] == 40 * 6.0
    assert (table["instructions"], table["depth"]) == (5, 4)
    assert table["chain_cycles"] == 4 * 5.0
    assert table["issue_cycles"] == 3 * 2.0
    assert cs.x1_lane_ms(sass, probe) == (273 * 35.0 + 15 * 20.0) / 2e6


def _launch_lanes(counts):
    """A stand-in for ops.cuda_verify's launch counters."""
    import collections
    import types

    lanes = {k: collections.Counter() for k in (
        "verify_kernel", "verify_kernel_cached", "build_pubkey_tables",
        "verify_kernel8", "verify_kernel8_cached")}
    for name, by_lanes in counts.items():
        lanes[name].update(by_lanes)
    return types.SimpleNamespace(LAUNCH_LANES=lanes)


def test_vote_lane_check_accepts_only_the_counts_compared():
    """On the vote path K2 may launch only at the lane counts of its own
    windows that were held against the plain version, not even at the
    kernels phase's counts; the other kernels keep the kernels phase's."""
    cs = _chip_smoke()
    cv = _launch_lanes({"verify_kernel_cached": {37: 2, 64: 1}})
    lanes = cs.check_lanes(cv, "vote", {"verify_kernel_cached": {37, 64}})
    assert lanes["verify_kernel_cached"] == {37: 2, 64: 1}
    with pytest.raises(RuntimeError, match="ran at \\[37, 64\\] lanes"):
        cs.check_lanes(cv, "vote", {"verify_kernel_cached": {37}})
    kernels_phase = _launch_lanes({"verify_kernel_cached": {cs.N_TIMED: 1}})
    cs.check_lanes(kernels_phase, "slice")
    with pytest.raises(RuntimeError):
        cs.check_lanes(kernels_phase, "vote", {"verify_kernel_cached": {37}})
    with pytest.raises(RuntimeError):  # X1 off its compared counts
        cs.check_lanes(_launch_lanes({"build_pubkey_tables": {37: 1}}),
                       "vote", {"verify_kernel_cached": {37}})


def test_vote_crossing_is_the_first_count_the_card_wins():
    cs = _chip_smoke()
    assert cs.crossing([(8, 1.0, 2.0), (16, 2.0, 2.1), (32, 3.0, 2.5),
                        (64, 1.0, 0.5)]) == 32
    assert cs.crossing([(8, 1.0, 2.0), (16, 2.0, 2.1)]) is None


def test_vote_window_record_holds_each_window_against_plain(monkeypatch):
    """WindowRecorder wraps ops.verify's launchers while entered (and
    restores them), keeps each window's wire rows and read-back verdicts,
    and compare_windows holds them against the plain version on the
    window's own lanes: equal here, and a flipped verdict is counted."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    seeds = [bytes([i]) * 32 for i in (1, 2)]
    msgs = [b"window lane 0", b"window lane 1"]
    pks = [ref.pubkey_from_seed(s) for s in seeds]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[1] = sigs[0]
    real = ov.verify_rsk_async
    with cs.WindowRecorder(ov) as rec:
        assert ov.verify_rsk_async is not real
        ok, bits = ov.verify_batch(pks, msgs, sigs, device="cpu")
        ov.verify_batch(pks[::-1], msgs[::-1], sigs[::-1], device="cpu")
    assert ov.verify_rsk_async is real
    assert bits.tolist() == [True, False]
    first, second = rec.records  # one arena: one plain call for both
    assert cs.window_record(first) == {
        "kernel": "verify_kernel_cached", "lanes": 2, "flavor": "4",
        "read_back": True, "mismatches": None}
    assert second["got"].tolist() == [False, True]
    err = dict.fromkeys(("verify_kernel", "verify_kernel_cached"), 0)
    mismatches = dict(err)
    assert cs.compare_windows(torch, rec.records, err, mismatches) == {
        "verify_kernel_cached": {2}}
    assert mismatches["verify_kernel_cached"] == 0
    second["got"] = np.array([True, True])
    cs.compare_windows(torch, rec.records, err, mismatches)
    assert (first["mismatches"], second["mismatches"]) == (0, 1)
    assert err["verify_kernel_cached"] == 1


def test_recorder_holds_x1_builds_against_plain(monkeypatch):
    """Given cuda_verify, WindowRecorder also records X1's launches (the
    arena builds), and compare_windows holds their tables and ok bits
    against the plain version: equal here, a changed limb counted."""
    import torch

    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    pks = [ref.pubkey_from_seed(bytes([i]) * 32) for i in (3, 4, 5)]
    real = cuda_verify.build_pubkey_tables
    cache = ov.pubkey_cache("cpu")
    with cs.WindowRecorder(ov, cuda_verify) as rec:
        idxs, _, arena_ok = cache.lookup(pks + [b""])
    assert cuda_verify.build_pubkey_tables is real
    (x1,) = rec.records
    assert (x1["kernel"], x1["lanes"]) == ("build_pubkey_tables", 4)
    # the b"" key builds from zero bytes, which decode (a point of order
    # 4); the arena's ok bit is the build's AND the key's length check
    assert x1["got"][1].tolist() == [True] * 4
    assert arena_ok[idxs.astype(int)].tolist() == [True, True, True, False]
    err = dict.fromkeys(cuda_verify.LAUNCHES, 0)
    mismatches = dict(err)
    assert cs.compare_windows(torch, rec.records, err, mismatches) == {
        "build_pubkey_tables": {4}}
    assert not any(mismatches.values())
    x1["got"] = (x1["got"][0].clone(), x1["got"][1])
    x1["got"][0][0, 0, 0, 1] += 1
    cs.compare_windows(torch, rec.records, err, mismatches)
    assert x1["mismatches"] == 1 and err["build_pubkey_tables"] == 1


class _SerialPool:
    """The pool chip_smoke maps its signing over, in this process."""

    @staticmethod
    def map(fn, chunks):
        return [fn(c) for c in chunks]


def test_mixed_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_mixed end to end at 2 x 12 validators: "cuda"
    mapped to the CPU, the plain versions counted as launches. Every run's
    route and launch count, the tampered lanes named, every launch held
    against its plain version and runs 1-4 against the host tier."""
    import torch

    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    for name, value in (("MIXED_ED", n), ("MIXED_SR", n),
                        ("MIXED_VALIDATORS", 2 * n),
                        ("MIXED_LIGHT", 2 * (2 * n) // 3 + 1),
                        ("MIXED_CHUNK", 10)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (
        fn(), (1.0, 0.0, 0))[1])
    monkeypatch.setattr(cs, "emit", lambda obj: None)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    real_resolve = ov.resolve_device
    monkeypatch.setattr(ov, "resolve_device", lambda d: real_resolve(
        "cpu" if torch.device(d).type == "cuda" else d))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else k["y_a"] if "y_a" in k
                     else a[0]).shape[-1]
            cv.LAUNCHES[_name] += 1
            cv.LAUNCH_LANES[_name][lanes] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, lanes, (err, mismatches) = cs.phase_mixed(
            torch, _SerialPool(), "cpu")
    finally:
        torch.set_num_threads(threads)
        cv.reset_launches()
    assert lanes["verify_kernel"] == {2 * n: 2}
    assert lanes["build_pubkey_tables"] == {n: 2}
    # runs 2 and 4 at 24 lanes, 3 at 17 (twice at 4 heights), 5 at 12,
    # 7 in chunks of 10 (the last 4 lanes below the cut, on the host)
    assert lanes["verify_kernel_cached"] == {2 * n: 4, 17: 8, n: 2, 10: 2}
    assert launches["verify_kernel8"] == launches["verify_kernel8_cached"] == 0
    assert not any(mismatches.values()) and not any(err.values())


class _Event:
    """torch.cuda.Event's surface on the CPU: every interval 0 ms."""

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


class _InlinePool(_SerialPool):
    """A spawned one-worker pool, run in this process."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def apply(fn, args):
        return fn(*args)

    def close(self):
        pass

    def join(self):
        pass


def test_rlc_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_rlc end to end on a 12-validator set (48 catch-up
    lanes): "cuda" mapped to the CPU, the plain versions counted as
    launches, X5's timing left out. Every comparison of the check, every
    run's verdicts, the lanes named, the launches of the path (X5 alone on
    good batches, K2 attributing the failed equations) and X5's shapes."""
    import types

    import torch

    from cometbft_tpu_torch.ops import cuda_rlc as cr
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    for name, value in (("N_VALIDATORS", n), ("RLC_SMALL", (5, 9)),
                        ("RLC_TAMPERED", 7), ("RLC_UNDECODABLE", 2),
                        ("RLC_SHORT", 10),
                        ("COMPARED_LANES", cs.COMPARED_LANES + (n,))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (
        fn(), (1.0, 0.5, 1))[1])
    # X5's timing with a fixed clock, SASS and 1 ms a timed call
    monkeypatch.setattr(cs, "clock_probe", lambda torch: {"clock_ghz": 2.0})
    monkeypatch.setattr(cs, "x1_sass", lambda path, probe: {"squaring": {
        "chain_cycles": 100.0, "issue_cycles": 500.0}})
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, reps=1: (
        1.0, fn()))
    from cometbft_tpu_torch.ops import build
    monkeypatch.setitem(build.BUILD_INFO, "build_tables.cu",
                        {"path": None})
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", "1")
    real_resolve = ov.resolve_device
    monkeypatch.setattr(ov, "resolve_device", lambda d: real_resolve(
        "cpu" if torch.device(d).type == "cuda" else d))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("verify_kernel_cached", "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else a[0]).shape[-1]
            cv.LAUNCHES[_name] += 1
            cv.LAUNCH_LANES[_name][lanes] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)
    real_x5 = cr.rlc_equation

    def counted_x5(*a, **k):
        shape = (k["y_a"].shape[1], k["y_r"].shape[1])
        cr.LAUNCHES["rlc"] += 1
        cr.LAUNCH_SHAPES["rlc"][shape] = cr.LAUNCH_SHAPES["rlc"].get(
            shape, 0) + 1
        return real_x5(*a, **k)
    monkeypatch.setattr(cr, "rlc_equation", counted_x5)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pool = _SerialPool()
        vals, _, commit = cs.make_commit(pool)
        launches, lanes, row = cs.phase_rlc(torch, pool, "cpu", vals, commit)
    finally:
        torch.set_num_threads(threads)
        cv.reset_launches()
        cr.reset_launches()
    assert row["mismatches"] == 0 and row["max_abs_err"] == 0
    # the bounds from the products the plans of the seeded z need, below
    # the reference's static count at the buckets 16 x 16 at n and 16 x 64
    # at 4n (which sums the pad slots too)
    for line, (na, nr) in ((row, (16, 16)), (row["at_40000"], (16, 64))):
        assert 0 < line["needed_products"] < line["op_ledger_products"]
        assert line["op_ledger_products"] == rlc.op_ledger(nr, na)[
            "field_muls_total"]
        assert line["bound_ms"] == 1e3 * 2 * cr.MULADDS_PER_PRODUCT * line[
            "needed_products"] / cs.PEAK_OPS_PER_S
        assert line["warp_issue_ms"] == 5 * line["chain_bound_ms"]
        assert line["ms"] == 1.0 and line["bound_share"] == line["bound_ms"]
        # X5's six stages by name, and its own chain by stage beside the
        # yardstick's
        assert list(line["stage_ms"]) == list(cr.STAGES) == [
            "decompress", "buckets", "runs", "groups", "join", "finish"]
        design = line["design_chain_products"]
        assert list(design) == list(cr.STAGES) + ["total"]
        assert design["total"] == sum(design[k] for k in cr.STAGES)
        assert line["design_chain_ms"] == design["total"] * 100.0 / (
            2.0 * 1e6)
        # the share against X5's own chain beside the operations and bytes
        assert line["design_bound_ms"] == max(
            line["ops_ms"], line["bytes_ms"], line["design_chain_ms"])
        assert line["design_bound_by"] == ("chain" if line[
            "design_chain_ms"] > max(line["ops_ms"], line["bytes_ms"])
            else line["bound_by"])
        assert line["design_bound_share"] == line["design_bound_ms"]
    assert row["k2_launches"] == 1 and row["at_40000"]["k2_launches"] == 4
    # 5 small batches, 30 ZIP-215 classes, both widths
    assert row["compared_launches"] == 37
    assert row["compared_shapes"] == ["16x16", "16x64", "8x8"]
    # runs 1-2 twice each; runs 3-4: three spoiled batches of 12 lanes
    assert lanes["rlc"] == {"16x16": 5, "16x64": 2}
    # K2 attributes the tampered and the undecodable lane, once each
    # (verify_batch's own bitmaps are taken before the path); X1 never runs
    assert lanes["verify_kernel_cached"] == {n: 2}
    assert launches["verify_kernel_cached"] == 2
    assert launches["build_pubkey_tables"] == 0 and launches["rlc"] == 7
    runs = [x for x in lines if x.get("phase") == "rlc.run"]
    assert [r["rejected"] for r in runs] == [[]] * 4 + [[7], [2], [10]]
    assert [x["lanes"] for x in lines
            if x.get("phase") == "rlc.breakdown"] == [n, 4 * n]
    assert [x["idle_share"] for x in lines
            if x.get("phase") == "rlc.trace"] == [0.5]
    assert [list(x["x5_stage_ms"]) for x in lines
            if x.get("phase") == "rlc.breakdown"] == [list(cr.STAGES)] * 2
    # X2's and X3's launches on the path are read with K1-K4's: none run
    # on the card here
    assert cs.OP_BY_PATH["rlc"] == {"x2_scatter": 0, "x3_unpack": 0,
                                    "x3_bitpack": 0}


def test_torch_ops_line_times_the_caches_own_scatter(monkeypatch):
    """time_torch_ops at 12 validators, "cuda" mapped to the CPU: X2's row
    times PubkeyTableCache._scatter itself (each timed call goes through
    it), the scatter lands the tables at the slots the cache assigned,
    and its bytes bound counts the tables and oks read and written and
    the slots read, where "port_bytes" adds the whole arena read and
    written by the out-of-place index_copy."""
    import torch

    from cometbft_tpu_torch.ops import curve, field
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    monkeypatch.setattr(cs, "N_VALIDATORS", n)
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, reps=1: (
        1.0, fn()))
    real_resolve = ov.resolve_device
    monkeypatch.setattr(ov, "resolve_device", lambda d: real_resolve(
        "cpu" if torch.device(d).type == "cuda" else d))
    calls = []
    real_scatter = ov.PubkeyTableCache._scatter

    def scatter(self, slots, tables, oks):
        calls.append(slots.tolist())
        return real_scatter(self, slots, tables, oks)
    monkeypatch.setattr(ov.PubkeyTableCache, "_scatter", scatter)
    vals, _, commit = cs.make_commit(_SerialPool())
    line = cs.time_torch_ops(torch, "card", vals, commit)
    assert line["phase"] == "torch_ops" and line["lanes"] == n
    # the timed call (time_ms's stand-in makes one), then the checked one
    assert calls == [list(range(n))] * 2
    x2 = line["ops"]["x2_scatter"]
    table_bytes = curve.TSIZE * 4 * field.NLIMB * 4 * n
    assert x2["bytes"] == 2 * (table_bytes + n) + 8 * n
    slots = ov.PubkeyTableCache.CAPACITY + 1
    assert x2["port_bytes"] == 2 * (table_bytes // n + 1) * slots + (
        table_bytes + n + 8 * n)
    assert x2["bound_ms"] == 1e3 * x2["bytes"] / cs.PEAK_BYTES_PER_S
    assert set(line["ops"]) == {"x2_scatter", "x3_unpack_k1",
                                "x3_unpack_k2", "x3_bitpack"}
    assert line["ops"]["x3_unpack_k1"]["bytes"] > 128 * n


def test_lane_check_refuses_an_x5_shape_not_compared():
    """check_lanes holds X5's launches to the shapes the rlc check
    compared: none outside the rlc path."""
    import types

    cs = _chip_smoke()
    x5 = types.SimpleNamespace(LAUNCH_SHAPES={"rlc": {(16384, 65536): 2}})
    quiet = _launch_lanes({})
    lanes = cs.check_lanes(quiet, "rlc", rlc_compared={(16384, 65536),
                                                        (8, 8)}, cuda_rlc=x5)
    assert lanes["rlc"] == {"16384x65536": 2}
    with pytest.raises(RuntimeError, match="X5 ran at"):
        cs.check_lanes(quiet, "rlc", rlc_compared={(16384, 16384)},
                       cuda_rlc=x5)
    with pytest.raises(RuntimeError, match="X5 ran at"):
        cs.check_lanes(quiet, "slice", cuda_rlc=x5)


def test_mesh_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_mesh end to end on a 12-validator set (12 commit
    lanes, 48 catch-up lanes): "cuda" mapped to the CPU, the plain versions
    counted as launches. The default-argument verify_batch takes K2 and
    does not shard; each mesh run equals it and names the tampered lane;
    K1 runs once a mesh entry at the padded shard counts; the h2d bytes
    are pack_inputs' 680 a padded lane."""
    import types

    import torch

    from cometbft_tpu_torch.libs import devstats
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    for name, value in (("N_VALIDATORS", n), ("MESH_TAMPERED", 7),
                        ("K1_MESH_LANES", (8, 16, 64))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "device_busy_ms", lambda torch, fn: (
        1.0, 0.5, 1))
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    monkeypatch.setenv("COMETBFT_TPU_PRESTAGE", "1")
    real_resolve = ov.resolve_device
    monkeypatch.setattr(ov, "resolve_device", lambda d: real_resolve(
        "cpu" if torch.device(d).type == "cuda" else d))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else a[0]).shape[-1]
            cv.LAUNCHES[_name] += 1
            cv.LAUNCH_LANES[_name][lanes] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)
    from cometbft_tpu_torch.ops import cuda_rlc as cr

    # the rlc phase ran before this one: its X5 counts must not reach the
    # mesh path's lane check
    cr.LAUNCH_SHAPES["rlc"][(16, 16)] = 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    devstats.enable()
    try:
        pool = _SerialPool()
        vals, _, commit = cs.make_commit(pool)
        launches, lanes = cs.phase_mesh(torch, pool, "cpu", vals, commit)
    finally:
        devstats.disable()
        torch.set_num_threads(threads)
        cv.reset_launches()
        cr.reset_launches()
    single = [x for x in lines if x["phase"] == "mesh.single"]
    assert [(x["lanes"], x["rejected"], x["sharded_calls"]) for x in single
            ] == [(n, [7], 0), (4 * n, [7], 0)]
    assert all("verify_kernel" not in x["launches"]
               and x["launches"]["verify_kernel_cached"] >= 1
               for x in single)
    runs = [x for x in lines if x["phase"] == "mesh.run"]
    # 12 lanes: 16 on (1, 1), 4 x 8 on (1, 4), 32 on (2, 2) with the
    # commit axis padded to 2 (4 x 16); 48: 64 on (1, 1), 4 x 16 on (1, 4)
    assert [(x["mesh"], x["lanes"], x["k1_by_lanes"], x["rejected"])
            for x in runs] == [
        ("1x1", n, {16: 1}, [7]), ("1x4", n, {8: 4}, [7]),
        ("2x2", n, {16: 4}, [7]), ("1x1", 4 * n, {64: 1}, [7]),
        ("1x4", 4 * n, {16: 4}, [7])]
    assert [x["h2d_bytes"] for x in runs] == [680 * w for w in (16, 32, 64,
                                                               64, 64)]
    assert [x["h2d_ops"] for x in runs] == [1, 4, 4, 1, 4]
    assert launches["verify_kernel"] == 14 and launches[
        "verify_kernel_cached"] == 0
    assert lanes["verify_kernel"] == {8: 4, 16: 9, 64: 1}
    assert [x["idle_share"] for x in lines
            if x["phase"] == "mesh.trace"] == [0.5]


def test_ledger_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_ledger end to end at 12 validators, a 10-validator
    commit and a 64-part block: "cuda" mapped to the CPU, the plain versions
    counted as launches. Run (1) keeps its windows on the host here (each
    plain K2 window costs ~1 s on the CPU); run (2)'s two windows and the
    hash plane's run on the plain versions. The listeners, the ledger's
    reconciliation, its window counts against the launches, the caller
    rows, the ring rows and the scraped lanes are checked as on the card;
    the torch.profiler round trip (a spawned process) is stubbed."""
    import types

    import torch

    from cometbft_tpu_torch.crypto import plane
    from cometbft_tpu_torch.libs import devledger, devstats, health, lockprof
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    monkeypatch.delenv("COMETBFT_TPU_DEVSTATS", raising=False)
    for name, value in (("LEDGER_VALIDATORS", n), ("LEDGER_TAMPERED", 5),
                        ("LEDGER_SMALL", 10), ("LEDGER_SMALL_TAMPERED", 3),
                        ("LEDGER_TURNS", 1), ("LEDGER_CUT", 1 << 30),
                        ("BLOCK_BYTES", 64 * 1_024)):
        monkeypatch.setattr(cs, name, value)
    # 1 KiB parts: 64 leaves of 17 blocks reach their bucket's seed cut
    # (2,048 // 32 = 64 lanes), and X4's plain version hashes them fast
    from cometbft_tpu_torch.types import part_set

    monkeypatch.setattr(part_set.PartSet.from_data.__func__, "__defaults__",
                        (1_024,))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    monkeypatch.setattr(cs, "_traced_ledger", lambda vals, votes: {
        "names_k2": True, "rejected": [5]})
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    real_resolve = ov.resolve_device

    def to_cpu(d):
        return real_resolve("cpu" if torch.device(d).type == "cuda" else d)
    for mod in (ov, plane, hashplane, sha256):
        monkeypatch.setattr(mod, "resolve_device", to_cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else k["y_a"] if "y_a" in k
                     else a[0]).shape[-1]
            cv.LAUNCHES[_name] += 1
            cv.LAUNCH_LANES[_name][lanes] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)

    def counted_x4(blocks, nblocks, _real=cuda_sha256.sha256):
        cuda_sha256.LAUNCHES["sha256"] += 1
        shape = (blocks.shape[0], blocks.shape[-1])
        shapes = cuda_sha256.LAUNCH_SHAPES["sha256"]
        shapes[shape] = shapes.get(shape, 0) + 1
        return _real(blocks, nblocks)
    monkeypatch.setattr(cuda_sha256, "sha256", counted_x4)
    compared = {(bb, lb) for bb in (1, 2, 32, 2048)  # 32: the 1 KiB leaves
                for lb in cs.X4_LANE_BUCKETS}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    devstats.acquire()  # as main() holds it for the libs line after
    try:
        sets = cs.make_ledger_sets(_SerialPool())
        launches, lanes, (err, mismatches), x4, x4_shapes = cs.phase_ledger(
            torch, "cpu", sets, compared)
        assert devstats.enabled()  # the phase's own hold released, not all
    finally:
        devstats.release()
        torch.set_num_threads(threads)
        cv.reset_launches()
        cuda_sha256.reset_launches()
        devledger.reset()
        health.reset()
        lockprof.reset()
    assert not devledger.enabled() and not health.enabled()
    assert not lockprof.enabled()
    out = [x for x in lines if x["phase"] == "ledger"][0]
    # X1 at both sets' prestage, K2 on run (2)'s two windows and on the
    # made commit's direct batch (11 signatures)
    assert lanes["build_pubkey_tables"] == {n: 1, 10: 1}
    assert lanes["verify_kernel_cached"] == {10: 2, n - 1: 1}
    assert not any(mismatches.values()) and not any(err.values())
    assert x4 == sum(x4_shapes.values()) > 0
    assert set(out["callers"]["verify"]) == {"consensus-vote",
                                             "commit-verify"}
    assert out["callers"]["verify"]["consensus-vote"]["lanes"] == 2 * n
    assert out["callers"]["verify"]["commit-verify"]["lanes"] == 20
    assert set(out["callers"]["hash"]) == {"merkle"}
    assert out["occupancy"]["verify"]["device_windows"] == 2
    assert out["occupancy"]["hash"]["device_windows"] == x4 == 1
    assert out["metrics"]["device_lanes_consensus_vote"] == 2 * n
    assert set(out["pprof"].values()) == {200}
    assert len(out["prevote_round_host_ms"]["accounting_on"]) == 1
    assert len(out["prevote_round_host_ms"]["accounting_off"]) == 1
    runs = [x for x in lines if x["phase"] == "ledger.run"]
    assert [r["run"][:3] for r in runs] == ["(1)", "(2)", "(3)"]


def test_chain_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_chain end to end at 12 validators and 3 heights:
    "cuda" mapped to the CPU, the plain versions counted as launches. The
    update comes at height 1 here, so the fourth block's LastCommit (the
    tampered one) is signed by 13: K2 at 12 and 13 lanes, X1 at 12 keys
    and at the added one. Every K2/X1/X4 launch held against its plain
    version, the tampered block refused with nothing changed, the
    reopened FileDBs equal to the last state and blocks; the traced warm
    height (a spawned process) is stubbed."""
    import types

    import torch

    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    for name, value in (("CHAIN_VALIDATORS", n), ("CHAIN_HEIGHTS", 3),
                        ("CHAIN_UPDATE_HEIGHT", 1), ("CHAIN_TAMPERED", 7),
                        # 64 txs of 1 KiB reach their bucket's seed cut
                        # (2,048 // 32 lanes): the tx keys go to X4
                        ("CHAIN_TXS", 64)):
        monkeypatch.setattr(cs, name, value)
    # 1 KiB parts, as in the ledger case: X4's plain version hashes their
    # leaves fast
    from cometbft_tpu_torch.types import part_set

    monkeypatch.setattr(part_set.PartSet.from_data.__func__, "__defaults__",
                        (1_024,))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    monkeypatch.setattr(cs, "_traced_chain", lambda pubs: (10.0, 1.0, 3))
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    _cuda_on_the_cpu(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (launches, lanes, (err, mismatches), x4, x4_shapes,
         (x4_err, x4_mismatches)) = cs.phase_chain(torch, "cpu")
    finally:
        torch.set_num_threads(threads)
        cv.reset_launches()
        cuda_sha256.reset_launches()
    assert lanes["verify_kernel_cached"] == {n: 2, n + 1: 1}
    assert lanes["build_pubkey_tables"] == {n: 1, 1: 1}
    assert launches["verify_kernel"] == launches["verify_kernel8"] == 0
    assert not any(mismatches.values()) and not any(err.values())
    assert x4 == sum(x4_shapes.values()) > 0
    assert x4_err == x4_mismatches == 0
    out = [x for x in lines if x["phase"] == "chain"][0]
    assert "wrong signature (#7)" in out["refused"]
    assert out["events"]["NewBlock"] == 3 and out["events"]["Tx"] == 3 * 64 + 1
    rows = [x for x in lines if x["phase"] == "chain.height"]
    assert [r["height"] for r in rows] == [1, 2, 3]
    assert [r["validators"] for r in rows] == [n, n, n + 1]
    assert rows[0]["k2_by_lanes"] == {} and rows[1]["x1_by_lanes"] == {n: 1}
    steps = rows[1]["host_ms"]["validate_block"]
    assert steps["total"] >= steps["verify_commit"] > 0
    assert steps["hashing"] > 0
    assert [x for x in lines if x["phase"] == "chain.trace"]


def _cuda_on_the_cpu(monkeypatch):
    """Map "cuda" to the CPU for a phase rehearsal: resolve_device in the
    modules that resolve, a no-op synchronize, and the plain versions of
    K1, K2, X1 and X4 counted as launches."""
    import torch

    from cometbft_tpu_torch.crypto import plane
    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    real_resolve = ov.resolve_device

    def to_cpu(d):
        return real_resolve("cpu" if torch.device(d).type == "cuda" else d)
    for mod in (ov, plane, hashplane, sha256):
        monkeypatch.setattr(mod, "resolve_device", to_cpu)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name in ("verify_kernel", "verify_kernel_cached",
                 "build_pubkey_tables"):
        def counted(*a, _real=getattr(cv, name), _name=name, **k):
            lanes = (k["y_r"] if "y_r" in k else k["y_a"] if "y_a" in k
                     else a[0]).shape[-1]
            cv.LAUNCHES[_name] += 1
            cv.LAUNCH_LANES[_name][lanes] += 1
            return _real(*a, **k)
        monkeypatch.setattr(cv, name, counted)

    def counted_x4(blocks, nblocks, _real=cuda_sha256.sha256):
        cuda_sha256.LAUNCHES["sha256"] += 1
        shape = (blocks.shape[0], blocks.shape[-1])
        shapes = cuda_sha256.LAUNCH_SHAPES["sha256"]
        shapes[shape] = shapes.get(shape, 0) + 1
        return _real(blocks, nblocks)
    monkeypatch.setattr(cuda_sha256, "sha256", counted_x4)


def test_consensus_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_consensus end to end at 12 validators and 3
    heights: "cuda" mapped to the CPU, the plain versions counted as
    launches. The burst's four nodes agree on five blocks; the node of
    run (2) commits every height in round 0 with the spoiled votes left
    out, the duplicate precommit's evidence in block 3 and the forged
    header's (K2 at its 5 signers) committed; every K2/X1/X4 launch held
    against its plain version; the traced height (a spawned process) is
    stubbed."""
    import types

    import torch

    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    n = 12
    for name, value in (("CHAIN_VALIDATORS", n), ("CONS_VALIDATORS", n),
                        ("CONS_HEIGHTS", 3), ("CONS_TAMPERED", (4, 5)),
                        ("CONS_DUP_VALIDATOR", 7),
                        ("CONS_ATTACK_SIGNERS", n // 3 + 1),
                        ("CONS_PEER_THREADS", 4), ("CHAIN_TXS", 64),
                        ("CONS_BURST_TXS", 8)):
        monkeypatch.setattr(cs, name, value)
    from cometbft_tpu_torch.types import part_set

    monkeypatch.setattr(part_set.PartSet.from_data.__func__, "__defaults__",
                        (1_024,))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    monkeypatch.setattr(cs, "_traced_consensus", lambda pubs: (10.0, 1.0, 3))
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    _cuda_on_the_cpu(monkeypatch)
    # the plain versions share this CPU with the node's threads: a window
    # may take longer than the card's 5 s bound
    from cometbft_tpu_torch.crypto import coalesce

    for mod in (coalesce, hashplane):
        monkeypatch.setattr(mod, "_RESULT_TIMEOUT_S", 120.0)
    # the forged header's 5 signers go to the card as its 3,334 do there
    from cometbft_tpu_torch.crypto import batch

    monkeypatch.setattr(batch, "HOST_BATCH_THRESHOLD", n // 3 + 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        (launches, lanes, (err, mismatches), x4, x4_shapes,
         (x4_err, x4_mismatches)) = cs.phase_consensus(torch, "cpu")
    finally:
        torch.set_num_threads(threads)
        cv.reset_launches()
        cuda_sha256.reset_launches()
        monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    assert lanes["verify_kernel_cached"].get(n // 3 + 1, 0) >= 1
    # the burst's set and run (2)'s (the plain X1 is slow on a CPU: the
    # burst's four nodes may each build their set before one finishes)
    assert lanes["build_pubkey_tables"].get(4, 0) >= 1
    assert lanes["build_pubkey_tables"].get(n, 0) >= 1
    assert launches["verify_kernel"] == launches["verify_kernel8"] == 0
    assert not any(mismatches.values()) and not any(err.values())
    assert x4 == sum(x4_shapes.values()) > 0
    assert x4_err == x4_mismatches == 0
    burst = [x for x in lines if x["phase"] == "consensus.burst"][0]
    assert min(burst["heights"]) >= 5 and len(burst["app_hashes"]) == 1
    rows = [x for x in lines if x["phase"] == "consensus.height"]
    assert [r["height"] for r in rows] == [1, 2, 3]
    assert [r["round"] for r in rows] == [0, 0, 0]
    assert rows[0]["own_proposal"] and not rows[1]["own_proposal"]
    assert rows[1]["evidence"] == ["LightClientAttackEvidence"]
    assert rows[2]["evidence"] == ["DuplicateVoteEvidence"]
    assert [r["txs"] for r in rows] == [64, 64, 64]
    steps = rows[1]["host_ms"]
    assert steps["proposal_to_durable"] >= steps["proposal_to_stored"] > 0
    assert steps["admission"] > 0 and steps["state_save"] > 0
    assert steps["preverify"] > 0 and steps["validate_block"] > 0
    assert sum(rows[1]["preverify_lanes"]) >= 2 * (n - 2)
    out = [x for x in lines if x["phase"] == "consensus"][0]
    assert out["evidence"]["duplicate_vote"] == 1
    assert out["evidence"]["light_client_attack"] == 1
    assert [x for x in lines if x["phase"] == "consensus.trace"]


def test_net_phase_runs_on_the_cpu_at_a_tiny_size(monkeypatch):
    """chip_smoke.phase_net end to end on the CPU: the burst's four port
    validators over localhost TCP commit five heights with node 3's txs
    queried at node 1; then 12 validators through a three-height chain, a
    byzantine server whose block 3 carries a spoiled
    LastCommit lane (heights 2 and 3 redone, the server stopped) and the
    honest one, from which the follower catches up two heights by
    blocksync and switches to consensus. "cuda" mapped to the CPU, the
    plain versions counted as launches and every K2/X1 launch held
    against its plain version; the traced height (a spawned process) is
    stubbed."""
    import types

    import torch

    from cometbft_tpu_torch.ops import cuda_sha256
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import verify as ov

    cs = _chip_smoke()
    for name, value in (("NET_VALIDATORS", 12), ("NET_LIGHT", 9),
                        ("NET_HEIGHTS", 3), ("NET_TAMPERED", 4),
                        ("NET_TRACE_HEIGHT", 2), ("NET_FRAME_REPS", 20),
                        ("NET_PLAIN_REPS", 2), ("NET_TXS", 8)):
        monkeypatch.setattr(cs, name, value)
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    monkeypatch.setattr(cs, "get_context", lambda method: types.
                        SimpleNamespace(Pool=lambda n: _InlinePool()))
    monkeypatch.setattr(cs, "_traced_net", lambda specs, raw: (10.0, 1.0, 3))
    monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    _cuda_on_the_cpu(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, lanes, (err, mismatches) = cs.phase_net(torch, "cpu")
    finally:
        torch.set_num_threads(threads)
        cv.reset_launches()
        cuda_sha256.reset_launches()
        monkeypatch.setattr(ov, "_PUBKEY_CACHE", {})
    assert lanes["verify_kernel_cached"][9] >= 3
    assert lanes["verify_kernel_cached"][12] >= 1
    assert launches["verify_kernel"] == launches["verify_kernel8"] == 0
    assert not any(mismatches.values()) and not any(err.values())
    frame = [x for x in lines if x["phase"] == "net.frame"][0]
    assert frame["native_seal_us"] < frame["plain_seal_us"]
    burst = [x for x in lines if x["phase"] == "net.burst"][0]
    assert min(burst["heights"]) >= 5 and burst["peers"] == [3, 1, 1, 1]
    rows = [x for x in lines if x["phase"] == "net.catchup.height"]
    assert [r["height"] for r in rows] == [1, 2]
    assert all(r["host_ms"]["apply_block"] > 0 for r in rows)
    out = [x for x in lines if x["phase"] == "net.catchup"][0]
    assert out["redone"][:2] == [2, 3] and out["synced"] >= 2
    assert "bad block" in out["stopped"][0]["reason"]
    assert out["burst_lanes"]["build_pubkey_tables"].get(4, 0) >= 1
    assert [x for x in lines if x["phase"] == "net.trace"]
