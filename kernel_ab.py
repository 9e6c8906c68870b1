#!/usr/bin/env python3
"""Variants of the verify kernels K1-K4 beside the tree's, on one CUDA card.

    python3 kernel_ab.py [--sizes 3334,6667,10000] [--probe NAME ...]
                         [--parent REV] [NAME=SOURCE.cu ...]
    python3 kernel_ab.py --parent REV --extract-only

Run from the root of a checkout. Each variant source builds with the flags
of cometbft_tpu_torch/ops/build.py (one nvcc each, all in parallel, into
build/ab/, with ops/csrc on the include path behind the source's own
directory). Every kernel, the tree's K1-K4 and the variants, is held
against its plain version on chip_smoke's seeded lanes at 1,000 lanes
(slots scattered over the cache's arena) and at each size (slots in
order), then timed at each size in turns: every kernel of a group in
order, then in reverse (chip_smoke.time_ms each: CUDA events around 10
back-to-back launches, median of 5 after a warm-up), so every kernel's
mean sits at the same mean position. A variant whose name starts with
"k1" takes K1's C entry and arguments, "k2" K2's, "k3" K3's and "k4"
K4's; K3 and K4 get the paired fixed-base table.

--parent REV times the K1 and K3 of commit REV (their sources and headers
as `git show` gives them, written to build/ab/parent-REV/ where the
checkout has a .git, and read from there where it has not: run with
--extract-only first to carry them to a machine without one) as
"K1@parent" and "K3@parent", with the C entries of the one-thread design
(a (16, 4, 20, N) global scratch a call, K3 on the 13-bit fixed-base
table). They take turns with the tree's K1 and K3 in a group of their
own, before the group of everything else: at 4-8 ms a launch they would
slow whichever kernel was timed next to them by a few per cent.

Probes are variants generated from the tree's own sources:

  k1_no_ladder, k3_no_ladder  K1, K3 without their 64 windows: the
                 prologue (K3's fixed-base sum, the decompressions, A's
                 table) and the tail
  k2_no_ladder   K2 without its 64 windows: R's decompression and the tail
  k4_no_ladder   K4 without its A ladder: the fixed-base sum, R's
                 decompression, the join and the tail
  k1_global, k3_global      K1, K3 with A's table in a global scratch of
                 the same per-thread plane layout (19,200 B a block, kept
                 by the C entry) in place of shared memory
  k2_block64, k4_block64    K2, K4 in two-warp blocks
  k2_block128, k4_block128  K2, K4 in four-warp blocks

A probe that changes what the kernel computes reports its mismatches and is
timed all the same. Prints one JSON line a step; the last is the summary,
with the card's name and power limit.
"""

import argparse
import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ab"
CSRC_REL = "cometbft_tpu_torch/ops/csrc"
LADDER = "for (int j = 0; j < 64; ++j) {"
NO_LADDER = [(LADDER, "for (int j = 0; j < 0; ++j) {")]
# A's table in device memory: one region of ATAB_WORDS a block, the C
# entry allocating (and growing) it and handing it over as a symbol
GLOBAL_ATAB = [
    ("  __shared__ uint32_t atab[ATAB_WORDS];\n",
     "  uint32_t* const atab = g_atab + (size_t)blockIdx.x * ATAB_WORDS;\n"),
    ("constexpr int LANES = BLOCK / 4;  // lanes a block\n",
     """constexpr int LANES = BLOCK / 4;  // lanes a block

__device__ uint32_t* g_atab;
static uint32_t* h_atab;
static size_t h_blocks;

static int ensure_atab(int n) {
  const size_t blocks = ((size_t)n + LANES - 1) / LANES;
  if (blocks <= h_blocks) return 0;
  if (h_atab != nullptr) cudaFree(h_atab);
  h_blocks = 0;
  int err = (int)cudaMalloc(&h_atab, blocks * ATAB_WORDS * sizeof(uint32_t));
  if (err != 0) return err;
  h_blocks = blocks;
  return (int)cudaMemcpyToSymbol(g_atab, &h_atab, sizeof(h_atab));
}
"""),
    (re.compile(r"prefer_max_shared\(\w+\)"), "ensure_atab(n)"),
]
PROBES = {
    "k1_no_ladder": ("verify_uncached.cu", NO_LADDER),
    "k3_no_ladder": ("verify8_uncached.cu", NO_LADDER),
    "k2_no_ladder": ("verify_cached.cu", NO_LADDER),
    "k4_no_ladder": ("verify8_cached.cu", NO_LADDER),
    "k1_global": ("verify_uncached.cu", GLOBAL_ATAB),
    "k3_global": ("verify8_uncached.cu", GLOBAL_ATAB),
}
# the block shape: the tree's one warp against two and four
for _k, _src in (("k2", "verify_cached.cu"), ("k4", "verify8_cached.cu")):
    for _threads, _blocks in ((64, 6), (128, 3)):
        PROBES[f"{_k}_block{_threads}"] = (_src, [
            ("int BLOCK = 32;", f"int BLOCK = {_threads};"),
            ("__launch_bounds__(BLOCK, 12)",
             f"__launch_bounds__(BLOCK, {_blocks})")])
# the parent's uncached kernels and what they include
PARENT_FILES = ("verify_uncached.cu", "verify8_uncached.cu",
                "kernel_common.cuh", "ed25519.cuh")


def probe_source(name: str, csrc: Path) -> Path:
    source, subs = PROBES[name]
    text = (csrc / source).read_text()
    for old, new in subs:
        if isinstance(old, re.Pattern):
            text, count = old.subn(new, text)
        else:
            count = text.count(old)
            text = text.replace(old, new)
        if count != 1:
            raise SystemExit(f"probe {name}: {old!r} found {count} times "
                             f"in {source}")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def parent_sources(rev: str) -> Path:
    """The parent's K1/K3 sources and headers under build/ab/parent-REV/,
    from `git show` unless they are there already."""
    out = OUT / f"parent-{rev}"
    if all((out / f).exists() for f in PARENT_FILES):
        return out
    if not (ROOT / ".git").exists():
        raise SystemExit(f"{out} is missing and {ROOT} is no git checkout: "
                         f"run --parent {rev} --extract-only where it is")
    out.mkdir(parents=True, exist_ok=True)
    for f in PARENT_FILES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC_REL}/{f}"],
                              cwd=ROOT, capture_output=True, check=True,
                              text=True).stdout
        (out / f).write_text(text)
    return out


def nvcc(build, csrc, name, src):
    so = OUT / f"lib{name.replace('@', '_')}.so"
    t = time.perf_counter()
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
         str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}: {proc.stderr[-3000:]}")
    return name, so, time.perf_counter() - t, build.ptxas_usage(proc.stderr)


def bind(name, lib):
    """The C entry of variant ``name`` with its argtypes: the tree's
    signature by the name's prefix, the one-thread design's for a
    parent."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "K1@parent":
        fn, types = lib.ed25519_verify, [ptr] * 9 + [i32, ptr]
    elif name == "K3@parent":
        fn, types = lib.ed25519_verify8, [ptr] * 10 + [i32, ptr]
    elif name.startswith("k1"):
        fn, types = lib.ed25519_verify, [ptr] * 8 + [i32, ptr]
    elif name.startswith("k3"):
        fn, types = lib.ed25519_verify8, [ptr] * 9 + [i32, ptr]
    elif name.startswith("k2"):
        fn = lib.ed25519_verify_cached
        types = [ptr] * 3 + [i32] + [ptr] * 6 + [i32, ptr]
    else:
        fn = lib.ed25519_verify8_cached
        types = [ptr] * 3 + [i32] + [ptr] * 7 + [i32, ptr]
    fn.argtypes = types
    fn.restype = i32
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="3334,6667,10000")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--parent", metavar="REV",
                    help="also time K1 and K3 of commit REV")
    ap.add_argument("--extract-only", action="store_true",
                    help="write the --parent sources and exit")
    ap.add_argument("variants", nargs="*", metavar="NAME=SOURCE.cu")
    args = ap.parse_args()
    if args.extract_only:
        if not args.parent:
            raise SystemExit("--extract-only needs --parent")
        print(parent_sources(args.parent))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cometbft_tpu_torch.ops import build, cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    sizes = [int(x) for x in args.sizes.split(",")]
    variants = dict(v.split("=", 1) for v in args.variants)
    for name in variants:
        if not name.startswith(("k1", "k2", "k3", "k4")):
            raise SystemExit(f"{name}: a variant's name starts with k1-k4")
    for name in args.probe:
        variants[name] = probe_source(name, build.CSRC)
    parents = []
    if args.parent:
        pdir = parent_sources(args.parent)
        variants["K1@parent"] = pdir / "verify_uncached.cu"
        variants["K3@parent"] = pdir / "verify8_uncached.cu"
        parents = ["K1@parent", "K3@parent"]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.emit({"card": smi, "parent": args.parent})
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cuda_verify._entries()
    with ThreadPoolExecutor(max(1, len(variants))) as pool:
        built = list(pool.map(lambda kv: nvcc(build, build.CSRC, *kv),
                              variants.items()))
    cs.emit({"build_s": time.perf_counter() - t0,
             "tree": {k: v for info in build.BUILD_INFO.values()
                      for k, v in build.ptxas_usage(info["ptxas"]).items()},
             "tree_nvcc_s": {k: v["seconds"]
                             for k, v in build.BUILD_INFO.items()},
             "variants": {n: {"nvcc_s": s, "ptxas": u}
                          for n, _, s, u in built}})
    entries = {name: bind(name, ctypes.CDLL(str(so)))
               for name, so, _, _ in built}
    consts = cuda_verify._consts(dev)
    tab8 = cuda_verify._base_table8_26(dev)
    tab8_13 = curve.base_table8(dev)

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
        cached = [arena.data_ptr(), arena_ok.data_ptr(), idxs.data_ptr(),
                  slots]

        def variant(name, n=n, a=a, a8=a8, rsk=rsk, rsk8=rsk8,
                    cached=cached):
            def run():
                out = torch.empty(n, dtype=torch.bool, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                head, tail = [], []
                if name in parents:
                    scratch = torch.empty((16, 4, 20, n), dtype=torch.int32,
                                          device=dev)
                    tail = [scratch.data_ptr()]
                kind = name[1] if name[0] == "k" else name[1:2]
                if kind == "1":
                    r = [a[k] for k in ("y_a", "sign_a", *rsk)]
                elif kind == "3":
                    r = [a8[k] for k in ("y_a", "sign_a", *rsk8)]
                    head = [tab8_13 if name in parents else tab8]
                elif kind == "2":
                    r, tail = list(rsk.values()), cached
                else:
                    r, head, tail = list(rsk8.values()), [tab8], cached
                ptrs = [*(t.data_ptr() for t in r), consts.data_ptr(),
                        *(t.data_ptr() for t in head)]
                if kind in "24":  # the arena leads
                    ptrs = tail + ptrs
                    tail = []
                err = entries[name](*ptrs, *tail, out.data_ptr(), n, stream)
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
                          plain8 if name.startswith("k4") else plain4)
        mismatches = {}
        for name, (fn, plain) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            mismatches[name] = int((got != plain).sum())
        cs.emit({"lanes": n, "slots_scattered": n == cs.N_RAGGED,
                 "mismatches": mismatches})
        if n == cs.N_RAGGED:
            continue
        groups = {"tree": [k for k in runs if k not in parents]}
        if parents:
            groups = {"parent": ["K1", "K1@parent", "K3", "K3@parent"],
                      **groups}
        summary[n] = {}
        for group, names in groups.items():
            order = names + names[::-1]
            ms = {}
            for name in order:
                ms.setdefault(name, []).append(
                    cs.time_ms(torch, runs[name][0], cs.KERNEL_REPS)[0])
            mean = {k: sum(v) / len(v) for k, v in ms.items()}
            line = {"lanes": n, "group": group, "order": order,
                    "ms_in_turns": ms}
            if group == "parent":
                line["new_over_parent"] = {
                    k: mean[k] / mean[f"{k}@parent"] for k in ("K1", "K3")}
            cs.emit(line)
            summary[n][group] = mean
    cs.emit({"summary_ms": summary, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
