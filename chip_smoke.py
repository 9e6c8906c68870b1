#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi) and torch's view.
2. build   — parallel nvcc builds of cometbft_tpu_torch/ops/csrc/*.cu,
             registers and spills per kernel (-Xptxas -v).
3. kernels — K1, K2 and X1 against their plain PyTorch versions on the card,
             on 4,096 seeded lanes, a ragged 1,000, and the main path's
             10,000 and 6,667 (the lanes tiled), valid lanes mixed with
             ZIP-215 edge lanes; K2 reads a pubkey arena of the cache's
             16,385 slots. Verdicts must be bit-identical (tables limb for
             limb), and a sample must agree with the ed25519 oracle. Then
             each is timed at 10,000 lanes (CUDA events, median of 5 runs
             after warm-up) beside its plain version and its bound.
4. slice   — a seeded 10,000-validator ed25519 set with equal power signs a
             precommit Commit; verify_commit runs with the pubkey cache off
             (K1), cold and warm with it on (X1, then K2), verify_commit_light
             runs warm, and a tampered signature must raise naming its index.
             Every kernel's launch counter must rise in this phase. Then one
             warm call's steps are timed on their own (slice.breakdown), and
             one warm call runs under torch.profiler for the card's idle
             share (slice.trace).

Then one line {"kernels": [...]}, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
nonzero and prints no last line. Without CUDA it exits 2.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from multiprocessing import get_context

CHAIN_ID = "chip-smoke-chain"
HEIGHT = 1000
N_VALIDATORS = 10_000
N_LANES = 4096
N_RAGGED = 1000
N_TIMED = 10_000
N_LIGHT = 2 * N_VALIDATORS // 3 + 1  # verify_commit_light's lanes
RUNS = 5
TAMPERED = 4321
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and the int32
# multiply-add rate. The data sheet gives 67 TFLOP/s float32 outside the
# tensor cores (128 FMA per clock per SM); on compute capability 9.0 an
# int32 multiply or multiply-add issues at 64 per clock per SM, half that
# (CUDA C++ Programming Guide, "Arithmetic Instructions" throughput
# table). A multiply-add counts as two operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12 / 2
# signing workers: the cores this process may use, at most 8 (a one-card
# machine may share a host whose os.cpu_count() is far larger)
WORKERS = min(8, len(os.sched_getaffinity(0)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _sign_chunk(items):
    """Worker: [(seed, msg)] -> [(pubkey, signature)]."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [(ref.pubkey_from_seed(s), ref.sign(s, m)) for s, m in items]


def _pubkey_chunk(seeds):
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    return [ref.pubkey_from_seed(s) for s in seeds]


def _pool_map(pool, fn, items):
    step = max(1, len(items) // (4 * WORKERS))
    chunks = [items[i : i + step] for i in range(0, len(items), step)]
    return [x for part in pool.map(fn, chunks) for x in part]


def _seed(tag: bytes, i: int) -> bytes:
    return hashlib.sha256(tag + i.to_bytes(8, "little")).digest()


# ------------------------------------------------------------------ lanes


def _order8_point(ref):
    y = 2
    while True:
        pt = ref.decompress(y.to_bytes(32, "little"))
        y += 1
        if pt is None:
            continue
        t = ref.scalar_mult(ref.L, pt)
        if not ref.is_identity(t) and not ref.is_identity(
            ref.point_double(ref.point_double(t))
        ):
            return t


def make_lanes(pool):
    """N_LANES seeded lanes; lanes 0-11 are edge lanes with known verdicts."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref

    items = [
        (_seed(b"lane-key", i % 256), b"lane message %d" % i)
        for i in range(N_LANES)
    ]
    signed = _pool_map(pool, _sign_chunk, items)
    pks = [p for p, _ in signed]
    sigs = [s for _, s in signed]
    msgs = [m for _, m in items]
    r = 123457
    r_enc = ref.compress(ref.scalar_mult(r, ref.BASE))
    rs = r_enc + r.to_bytes(32, "little")
    s0 = int.from_bytes(sigs[8][32:], "little")
    edge = {
        1: ("flipped signature bit", None, None,
            bytes([sigs[1][0] ^ 1]) + sigs[1][1:], False),
        2: ("wrong message", None, b"tampered", None, False),
        3: ("wrong key", pks[300], None, None, False),
        4: ("identity key y = 1 + p", (1 + ref.P).to_bytes(32, "little"),
            None, ref.compress(ref.scalar_mult(7, ref.BASE))
            + (7).to_bytes(32, "little"), True),
        5: ("A off the curve", (2).to_bytes(32, "little"), None, None, False),
        6: ("R off the curve", None, None,
            (2).to_bytes(32, "little") + sigs[6][32:], False),
        8: ("S >= L, host reject", None, None,
            sigs[8][:32] + (s0 + ref.L).to_bytes(32, "little"), False),
        9: ("S = L, host reject", None, None,
            sigs[9][:32] + ref.L.to_bytes(32, "little"), False),
        10: ("negative zero A", (1 | 1 << 255).to_bytes(32, "little"), None,
             rs, True),
        11: ("truncated signature", None, None, sigs[11][:40], False),
    }
    a8 = ref.compress(_order8_point(ref))
    m8 = next(
        b"small-order %d" % i for i in range(64)
        if ref.challenge_scalar(r_enc, a8, b"small-order %d" % i) % 8
    )
    edge[7] = ("small-order A, cofactored accept", a8, m8, rs, True)
    expect = {0: True}
    for i, (_name, pk, msg, sig, verdict) in edge.items():
        pks[i] = pk if pk is not None else pks[i]
        msgs[i] = msg if msg is not None else msgs[i]
        sigs[i] = sig if sig is not None else sigs[i]
        expect[i] = verdict
    for i, verdict in expect.items():
        check(ref.verify(pks[i], msgs[i], sigs[i]) == verdict,
              f"edge lane {i} oracle verdict")
    return pks, msgs, sigs, expect


# ---------------------------------------------------------------- timing


def time_ms(torch, fn):
    """(median ms of RUNS calls after one warm-up, CUDA events; the last
    call's output)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def bound(cuda_verify, name: str, lanes: int):
    ops_ms = 1e3 * 2 * cuda_verify.MULADDS_PER_LANE[name] * lanes / PEAK_OPS_PER_S
    bytes_ms = 1e3 * cuda_verify.BYTES_PER_LANE[name] * lanes / PEAK_BYTES_PER_S
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


# ----------------------------------------------------------------- phases


def phase_kernels(torch, pool):
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    pks, msgs, sigs, expect = make_lanes(pool)
    emit({"phase": "kernels.inputs", "lanes": N_LANES,
          "edge_lanes": len(expect), "seconds": time.perf_counter() - t0})
    buf, host_ok = ov.pack_bytes(pks, msgs, sigs)
    wire = torch.from_numpy(buf).to(dev)
    # K2 reads an arena of PubkeyTableCache's CAPACITY + 1 slots. At the
    # main path's sizes the slots are 0..n-1 in lane order, as a cold fill
    # of the cache assigns them (and as K2 is timed); at the two smaller
    # sizes they are scattered over the whole arena, as after evictions.
    slots = ov.PubkeyTableCache.CAPACITY + 1
    oracle = {}  # lane -> ed25519_ref verdict; larger sizes tile the lanes
    err = {"verify_kernel": 0, "verify_kernel_cached": 0,
           "build_pubkey_tables": 0}
    mismatches = dict(err)
    for n in (N_LANES, N_RAGGED, N_TIMED, N_LIGHT):
        cols = torch.arange(n, device=dev) % N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        rsk = {k: a[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
        if n in (N_TIMED, N_LIGHT):
            slot = torch.arange(n, device=dev)
        else:
            gen = torch.Generator().manual_seed(n)
            slot = torch.randperm(slots - 1, generator=gen)[:n].to(dev)
        k1 = cuda_verify.verify_kernel(**a)
        table, tab_ok = cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])
        arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32, device=dev)
        arena[..., slot] = table
        arena_ok = torch.zeros(slots, dtype=torch.bool, device=dev)
        arena_ok[slot] = tab_ok
        idxs = slot.to(torch.int16)
        k2 = cuda_verify.verify_kernel_cached(arena, arena_ok, **rsk,
                                              idxs=idxs)
        table_plain, tab_ok_plain = curve.build_pubkey_tables(
            a["y_a"], a["sign_a"]
        )
        torch.cuda.synchronize()
        for name, got, plain in (
            ("verify_kernel", k1, curve.verify_kernel(**a)),
            ("verify_kernel_cached", k2,
             curve.verify_kernel_slots(arena, arena_ok, idxs, **rsk)),
            ("build_pubkey_tables", table, table_plain),
            ("build_pubkey_tables", tab_ok, tab_ok_plain),
        ):
            diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
            err[name] = max(err[name], int(diff.max()))
            mismatches[name] += int((diff != 0).sum())
        valid = k1.cpu().numpy() & host_ok[cols.cpu().numpy()]
        for i, verdict in expect.items():
            check(bool(valid[i]) == verdict, f"edge lane {i} verdict (n={n})")
        sample = list(range(len(expect), n, max(1, n // 48)))
        for i in sample:
            j = i % N_LANES
            if j not in oracle:
                oracle[j] = ref.verify(pks[j], msgs[j], sigs[j])
            check(bool(valid[i]) == oracle[j],
                  f"lane {i} disagrees with the oracle (n={n})")
        check(bool((k2 == k1).all()), f"K2 and K1 verdicts differ (n={n})")
        emit({"phase": "kernels.compare", "lanes": n, "arena_slots": slots,
              "slots_scattered": n not in (N_TIMED, N_LIGHT),
              "mismatches": dict(mismatches), "oracle_lanes":
              len(expect) + len(sample), "valid_lanes": int(valid.sum())})
        if n == N_TIMED:
            timed_inputs = (a, rsk, arena, arena_ok, idxs, k1, k2, table)
    check(not any(mismatches.values()), f"kernel != plain: {mismatches}")

    # timing at 10,000 lanes, on the inputs compared above; each timed
    # kernel's last output must equal the one compared
    a, rsk, arena, arena_ok, idxs, k1, k2, table = timed_inputs
    runs = {
        "verify_kernel": (
            lambda: cuda_verify.verify_kernel(**a),
            lambda: curve.verify_kernel(**a),
            k1,
        ),
        "verify_kernel_cached": (
            lambda: cuda_verify.verify_kernel_cached(
                arena, arena_ok, **rsk, idxs=idxs),
            lambda: curve.verify_kernel_slots(arena, arena_ok, idxs, **rsk),
            k2,
        ),
        "build_pubkey_tables": (
            lambda: cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])[0],
            lambda: curve.build_pubkey_tables(a["y_a"], a["sign_a"]),
            table,
        ),
    }
    timed = {}
    for name, (kernel, plain, compared) in runs.items():
        ms, out = time_ms(torch, kernel)
        check(torch.equal(out, compared), f"{name}: timed output changed")
        plain_ms, _ = time_ms(torch, plain)
        bound_ms, bound_by = bound(cuda_verify, name, N_TIMED)
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err[name],
                       "mismatches": mismatches[name]}
        emit({"phase": "kernels.time", "kernel": name, "lanes": N_TIMED,
              **timed[name]})
    return timed


def make_commit(pool):
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.types import block
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    seeds = [_seed(b"validator", i) for i in range(N_VALIDATORS)]
    pubs = _pool_map(pool, _pubkey_chunk, seeds)
    vals = ValidatorSet([Validator(Ed25519PubKey(p), 100) for p in pubs])
    seed_of = {Ed25519PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    block_id = block.BlockID(
        hashlib.sha256(b"block").digest(),
        block.PartSetHeader(2, hashlib.sha256(b"parts").digest()),
    )
    unsigned = [
        block.CommitSig(block.BLOCK_ID_FLAG_COMMIT, v.address,
                        1_760_000_000_000_000_000 + 7919 * i)
        for i, v in enumerate(vals.validators)
    ]
    commit = block.Commit(HEIGHT, 0, block_id, unsigned)
    items = [
        (seed_of[cs.validator_address], commit.vote_sign_bytes(CHAIN_ID, i))
        for i, cs in enumerate(unsigned)
    ]
    signed = _pool_map(pool, _sign_chunk, items)
    commit.signatures = [
        block.CommitSig(cs.block_id_flag, cs.validator_address,
                        cs.timestamp_ns, sig)
        for cs, (_, sig) in zip(unsigned, signed)
    ]
    return vals, block_id, commit


def phase_slice(torch, pool, card):
    from cometbft_tpu_torch.ops import cuda_verify
    from cometbft_tpu_torch.ops import verify as ov
    from cometbft_tpu_torch.types import block, validation

    t0 = time.perf_counter()
    vals, block_id, commit = make_commit(pool)
    emit({"phase": "slice.commit", "validators": len(vals),
          "signatures": len(commit.signatures),
          "seconds": time.perf_counter() - t0})
    cache = ov.PubkeyTableCache(device="cuda")
    bad = block.Commit(commit.height, commit.round, commit.block_id,
                       list(commit.signatures))
    cs = bad.signatures[TAMPERED]
    sig = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    bad.signatures[TAMPERED] = block.CommitSig(
        cs.block_id_flag, cs.validator_address, cs.timestamp_ns, sig)

    calls = [
        ("verify_commit", "cache off", validation.verify_commit, None, commit),
        ("verify_commit", "cache cold", validation.verify_commit, cache,
         commit),
        ("verify_commit", "cache warm", validation.verify_commit, cache,
         commit),
        ("verify_commit", "cache warm", validation.verify_commit, cache,
         commit),
        ("verify_commit_light", "cache warm", validation.verify_commit_light,
         cache, commit),
        ("verify_commit", "tampered, cache warm", validation.verify_commit,
         cache, bad),
    ]
    torch.cuda.synchronize()
    cuda_verify.reset_launches()  # the main path starts here
    per_call = []
    for fn_name, mode, fn, pubkey_cache, c in calls:
        before = dict(cuda_verify.LAUNCHES)
        t = time.perf_counter()
        error = None
        try:
            fn(CHAIN_ID, vals, block_id, HEIGHT, c, device="cuda",
               pubkey_cache=pubkey_cache)
        except validation.VerificationError as e:
            error = str(e)
        seconds = time.perf_counter() - t
        if c is bad:
            check(error is not None and f"(#{TAMPERED})" in error,
                  f"tampered commit: {error!r}")
        else:
            check(error is None, f"{fn_name} ({mode}) rejected: {error}")
        sigs = len(c.signatures) if fn_name == "verify_commit" else (
            2 * len(c.signatures) // 3 + 1)
        launches = {k: v - before[k] for k, v in cuda_verify.LAUNCHES.items()}
        per_call.append(launches)
        emit({"phase": "slice.call", "call": fn_name, "mode": mode,
              "ms": 1e3 * seconds, "sigs_per_s": sigs / seconds,
              "signatures": sigs, "launches": launches, "error": error,
              "card": card})
    launches = dict(cuda_verify.LAUNCHES)  # read just after the main path
    check(per_call[0]["verify_kernel"] >= 1, "cache-off call launched no K1")
    check(per_call[1]["build_pubkey_tables"] >= 1, "cold call built nothing")
    check(per_call[2]["verify_kernel_cached"] >= 1
          and per_call[2]["build_pubkey_tables"] == 0,
          "warm call did not run K2 alone")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    emit({"phase": "slice", "launches": launches,
          "cache": {"hits": cache.hits, "misses": cache.misses,
                    "builds": cache.builds}})

    # where a warm verify_commit's time goes, each step on its own (host
    # clock; "device" is h2d + unpack + K2 + bit-pack + readback)
    steps = {}
    t = time.perf_counter()
    msgs = [commit.vote_sign_bytes(CHAIN_ID, i)
            for i in range(len(commit.signatures))]
    steps["sign_bytes_ms"] = 1e3 * (time.perf_counter() - t)
    pubs = [v.pub_key.data for v in vals.validators]
    sigs = [cs.signature for cs in commit.signatures]
    t = time.perf_counter()
    buf, _ = ov.pack_bytes(pubs, msgs, sigs)
    steps["pack_bytes_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    idxs, arena, arena_ok = cache.lookup(pubs)
    steps["cache_lookup_ms"] = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = ov.verify_rsk_async(buf[32:], idxs, arena, arena_ok, len(pubs))()
    steps["device_ms"] = 1e3 * (time.perf_counter() - t)
    check(bool(ok.all()), "breakdown verify rejected the commit")
    emit({"phase": "slice.breakdown", "signatures": len(pubs), **steps,
          "card": card})

    # the card's busy and idle share of one warm verify_commit, read from
    # a torch.profiler trace (host clock for the call, trace for the card)
    host_ms, busy_ms, events = device_busy_ms(
        torch, lambda: validation.verify_commit(
            CHAIN_ID, vals, block_id, HEIGHT, commit, device="cuda",
            pubkey_cache=cache))
    emit({"phase": "slice.trace", "call": "verify_commit", "mode":
          "cache warm, profiled", "host_ms": host_ms,
          "device_busy_ms": busy_ms, "device_events": events,
          "idle_share": 1 - busy_ms / host_ms if events else None,
          "card": card})
    return launches


def device_busy_ms(torch, fn):
    """(host ms, card-busy ms, device events) of one fn() call under
    torch.profiler: busy is the union of the card's kernel, copy and set
    intervals in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return host_ms, busy_us / 1e3, len(spans)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # the port itself: outside a checkout this fails before any output
    from cometbft_tpu_torch.ops import build, cuda_verify

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_verify._entries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {src: info["seconds"]
                           for src, info in build.BUILD_INFO.items()},
          "kernels": {k: v for info in build.BUILD_INFO.values()
                      for k, v in build.ptxas_usage(info["ptxas"]).items()}})

    with get_context("spawn").Pool(WORKERS) as pool:
        timed = phase_kernels(torch, pool)
        launches = phase_slice(torch, pool, smi)
        pool.close()
        pool.join()

    replaces = {
        "verify_kernel": "cometbft_tpu/ops/pallas_verify.py:922",
        "verify_kernel_cached": "cometbft_tpu/ops/pallas_verify.py:858",
        "build_pubkey_tables": "cometbft_tpu/ops/verify.py:442",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "cometbft_tpu_torch/ops/csrc/" + cuda_verify.SOURCES[name],
         "replaces": replaces[name], "launches": launches[name],
         **timed[name], "library_ms": None}
        for name in ("verify_kernel_cached", "verify_kernel",
                     "build_pubkey_tables")
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
