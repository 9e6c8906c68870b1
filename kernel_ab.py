#!/usr/bin/env python3
"""Variants of the cached verify kernels K2 and K4 beside the tree's, on one
CUDA card.

    python3 kernel_ab.py [--sizes 3334,6667,10000] [--probe NAME ...]
                         [NAME=SOURCE.cu ...]

Run from the root of a checkout. Each variant source builds with the flags
of cometbft_tpu_torch/ops/build.py (one nvcc each, all in parallel, into
build/ab/, with ops/csrc on the include path). Every kernel, the tree's
K1-K4 and the variants, is held against its plain version on chip_smoke's
seeded lanes at 1,000 lanes (slots scattered over the cache's arena) and
at each size (slots in order), then timed at each size in turns: every
kernel in order, then in reverse (chip_smoke.time_ms each: CUDA events
around 10 back-to-back launches, median of 5 after a warm-up), so every
kernel's mean sits at the same mean position. K1 and K3 take their own turns first: at 4-8 ms a launch they
slowed whichever kernel was timed next to them by a few per cent. A variant whose name starts with "k2" takes K2's C entry and
arguments, "k4" K4's, with the paired fixed-base table.

Probes are variants generated from the tree's own sources, one
substitution each:

  k2_no_ladder   K2 without its 64 windows: R's decompression and the tail
  k4_no_ladder   K4 without its A ladder: the fixed-base sum, R's
                 decompression, the join and the tail
  k2_block64, k4_block64    K2, K4 in two-warp blocks
  k2_block128, k4_block128  K2, K4 in four-warp blocks

A probe that changes what the kernel computes reports its mismatches and is
timed all the same. Prints one JSON line a step; the last is the summary,
with the card's name and power limit.
"""

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ab"
LADDER = "for (int j = 0; j < 64; ++j) {"
PROBES = {
    "k2_no_ladder": ("verify_cached.cu",
                     [(LADDER, "for (int j = 0; j < 0; ++j) {")]),
    "k4_no_ladder": ("verify8_cached.cu",
                     [(LADDER, "for (int j = 0; j < 0; ++j) {")]),
}
# the block shape: the tree's one warp against two and four
for _k, _src in (("k2", "verify_cached.cu"), ("k4", "verify8_cached.cu")):
    for _threads, _blocks in ((64, 6), (128, 3)):
        PROBES[f"{_k}_block{_threads}"] = (_src, [
            ("int BLOCK = 32;", f"int BLOCK = {_threads};"),
            ("__launch_bounds__(BLOCK, 12)",
             f"__launch_bounds__(BLOCK, {_blocks})")])


def probe_source(name: str, csrc: Path) -> Path:
    source, subs = PROBES[name]
    text = (csrc / source).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"probe {name}: {old!r} not in {source}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def nvcc(build, csrc, name, src):
    so = OUT / f"lib{name}.so"
    t = time.perf_counter()
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
         str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}: {proc.stderr[-3000:]}")
    return name, so, time.perf_counter() - t, build.ptxas_usage(proc.stderr)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="3334,6667,10000")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("variants", nargs="*", metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cometbft_tpu_torch.ops import build, cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    sizes = [int(x) for x in args.sizes.split(",")]
    variants = dict(v.split("=", 1) for v in args.variants)
    for name in args.probe:
        variants[name] = probe_source(name, build.CSRC)
    for name in variants:
        if not name.startswith(("k2", "k4")):
            raise SystemExit(f"{name}: a variant's name starts with k2 or k4")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.emit({"card": smi})
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cuda_verify._entries()
    with ThreadPoolExecutor(max(1, len(variants))) as pool:
        built = list(pool.map(lambda kv: nvcc(build, build.CSRC, *kv),
                              variants.items()))
    cs.emit({"build_s": time.perf_counter() - t0,
             "tree": {k: v for info in build.BUILD_INFO.values()
                      for k, v in build.ptxas_usage(info["ptxas"]).items()},
             "variants": {n: {"nvcc_s": s, "ptxas": u}
                          for n, _, s, u in built}})
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name, so, _, _ in built:
        lib = ctypes.CDLL(str(so))
        if name.startswith("k2"):
            fn = lib.ed25519_verify_cached
            fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 6 + [i32, ptr]
        else:
            fn = lib.ed25519_verify8_cached
            fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 7 + [i32, ptr]
        fn.restype = i32
        entries[name] = fn
    consts = cuda_verify._consts(dev)
    tab8 = cuda_verify._base_table8_26(dev)

    with get_context("spawn").Pool(cs.WORKERS) as pool:
        pks, msgs, sigs, _ = cs.make_lanes(pool)
    buf, _ = ov.pack_bytes(pks, msgs, sigs)
    wire = torch.from_numpy(buf).to(dev)
    slots = ov.PubkeyTableCache.CAPACITY + 1
    summary = {}
    for n in [cs.N_RAGGED] + sizes:
        cols = torch.arange(n, device=dev) % cs.N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        a8 = ov.unpack_on_device(wire[:, cols], "8")
        rsk = {k: a[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
        rsk8 = {k: a8[k] for k in ("y_r", "sign_r", "s_bytes", "kneg_nibs")}
        if n == cs.N_RAGGED:
            gen = torch.Generator().manual_seed(n)
            slot = torch.randperm(slots - 1, generator=gen)[:n].to(dev)
        else:
            slot = torch.arange(n, device=dev)
        table, tab_ok = cuda_verify.build_pubkey_tables(a["y_a"], a["sign_a"])
        arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32, device=dev)
        arena[..., slot] = table
        arena_ok = torch.zeros(slots, dtype=torch.bool, device=dev)
        arena_ok[slot] = tab_ok
        idxs = slot.to(torch.int16)
        plain4 = curve.verify_kernel_slots(arena, arena_ok, idxs, **rsk)
        plain8 = curve.verify_kernel8_slots(arena, arena_ok, idxs, **rsk8)

        def variant(name, n=n, arena=arena, arena_ok=arena_ok, idxs=idxs,
                    rsk=rsk, rsk8=rsk8):
            def run():
                out = torch.empty(n, dtype=torch.bool, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                if name.startswith("k2"):
                    r = rsk
                    extra = [consts]
                else:
                    r = rsk8
                    extra = [consts, tab8]
                err = entries[name](
                    arena.data_ptr(), arena_ok.data_ptr(), idxs.data_ptr(),
                    slots, *(r[k].data_ptr() for k in r),
                    *(t.data_ptr() for t in extra), out.data_ptr(), n, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
                return out
            return run

        runs = {
            "K1": (lambda a=a: cuda_verify.verify_kernel(**a), plain4),
            "K3": (lambda a8=a8: cuda_verify.verify_kernel8(**a8), plain4),
            "K2": (lambda: cuda_verify.verify_kernel_cached(
                arena, arena_ok, **rsk, idxs=idxs), plain4),
            "K4": (lambda: cuda_verify.verify_kernel8_cached(
                arena, arena_ok, **rsk8, idxs=idxs), plain8),
        }
        for name in entries:
            runs[name] = (variant(name),
                          plain4 if name.startswith("k2") else plain8)
        mismatches = {}
        for name, (fn, plain) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            mismatches[name] = int((got != plain).sum())
        cs.emit({"lanes": n, "slots_scattered": n == cs.N_RAGGED,
                 "mismatches": mismatches})
        if n == cs.N_RAGGED:
            continue
        ms = {}
        for group in (["K1", "K3"], [k for k in runs if k not in ("K1", "K3")]):
            order = group + group[::-1]
            for name in order:
                ms.setdefault(name, []).append(
                    cs.time_ms(torch, runs[name][0], cs.KERNEL_REPS)[0])
            cs.emit({"lanes": n, "order": order,
                     "ms_in_turns": {k: ms[k] for k in group}})
        summary[n] = {k: sum(v) / len(v) for k, v in ms.items()}
    cs.emit({"summary_ms": summary, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
