#!/usr/bin/env python3
"""Variants of the verify kernels K1-K4, and an older commit's X4, X1 and
X5, beside the tree's, on one CUDA card.

    python3 kernel_ab.py [--sizes 3334,6667,10000] [--probe NAME ...]
                         [--parent REV] [--only verify|x4|x1|x5]
                         [NAME=SOURCE.cu ...]
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

--parent REV also takes REV's csrc/sha256.cu as "X4@parent" (the C entry
sha256_blocks has not changed). On chip_smoke's seeded default block,
X4 and X4@parent are first held against hashlib and the plain version
at the three shapes the hash path launches X4 at: the 336 part leaves
(2,048 x 512), a gossip window of 5 leaves (2,048 x 8) and a full tx-key
window (64 x 2,048); then timed in turns at each (X4, X4@parent,
X4@parent, X4), beside the throughput bound (chip_smoke.x4_bound) and
the chain bound (chip_smoke.x4_chain_bound_ms, on clock_probe's latency
and clock from the same run). Both are also timed as one warp's worth of
leaves (chip_smoke.x4_one_warp: cycles a compression), and their SASS
is counted (chip_smoke.x4_sass_counts), with a copy of the parent's
source whose message schedule is cut ("X4@parent_no_schedule", built
for its SASS only): the parent's loop less that one's is its schedule.

--parent REV also takes REV's csrc/build_tables.cu (with the headers it
includes) as "X1@parent" (the C entry ed25519_build_tables has not
changed). X1, X1@parent and the x1 probes are held against X1's plain
version (tables limb for limb, ok bits) on chip_smoke's seeded lanes at
1,000 lanes and at 10,000 and 5,000 (a light-phase key group), then
timed in turns at 10,000 and 5,000 beside the throughput bound and the
chain bound (chip_smoke.x1_lane_ms, on X1's SASS and on
clock_probe's latency and clock from the same run); their SASS is
summarised (chip_smoke.x1_sass).

--only x5 --parent REV takes REV's csrc/rlc.cu (and its fe26.cuh) as
"X5@parent", launched through its C entry x5_rlc_stage with the
four-launch design's scratch layout (x5_parent_entry). On chip_smoke's
seeded rlc lanes (the commit's 10,000 and the 40,000-lane catch-up over
10,000 keys, folded with chip_smoke's seed) X5 and X5@parent are held
against the plain version (window sums and total as encodings, the
bool), then timed in turns (X5, X5@parent, X5@parent, X5) at 16,384 x
16,384 and 16,384 x 65,536, stage by stage (CUDA events), beside the
bounds of cuda_rlc.work and chip_smoke.chain_products and X5's own chain
(chip_smoke.design_chain); their SASS is summarised (x5_sass), and a
clock64() copy of each (X5_PHASES on the tree's source, X5_PARENT_PHASES
on REV's) gives the phases of its serial stages in cycles: the join's
windows and [b]B, the finish's staging, Horner walks and cofactor test
(the parent: its finish's ok-byte scan, join of runs, Horner walks, [b]B
and test). It needs no variant or probe.

--only verify, --only x4, --only x1 or --only x5 runs one of the parts.

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
  x1_warps1, x1_warps2, x1_warps8  X1 in blocks of one, two or eight
                 warps (8, 16 or 64 lanes; the first warp decompresses the
                 block's lanes, so one warp decompresses 8 lanes in
                 x1_warps1, the cost of one lane a quad throughout)
  x1_no_adds     X1 without the table's 13 affine adds
  x1_no_sqrt     X1 without A's sqrt chain
  x1_dec_rot     X1 with warp ((%warpid of warp 0) / 4) % 4 decompressing
  x1_regs255     X1 allowed 255 registers (two blocks an SM)
  x1_phases      X1 with clock64() stamps a block: kernel_ab reads them
                 back and reports its blocks' decompression and table
                 cycles by how many blocks shared their SM

A probe that changes what the kernel computes reports its mismatches and is
timed all the same. Prints one JSON line a step; the last is the summary,
with the card's name and power limit.
"""

import argparse
import ctypes
import hashlib
import re
import statistics
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
# X4 (csrc/sha256.cu) variants generated from the tree's source, all but
# the first computing the same digests:
#   x4_rounds_only  the schedule warp's work cut: what the round warp
#                   costs alone (its digests are wrong)
#   x4_e_imad       the new e as two multiply-adds by `one` (IMADs, its
#                   chain four steps), as the first redesign had it
#   x4_iadd3        every addition a plain add (ptxas picks IADD3 or IMAD)
#   x4_textbook     the round as FIPS 180-4 writes it: T1 = h + W + K +
#                   Sigma1 + Ch, e = d + T1, a = T1 + Sigma0 + Maj
#   x4_ex           e = (d + h + W + K) + Sigma1 + Ch, a = e + (Sigma0 +
#                   Maj - d): five plain adds, the e chain three steps
#   x4_wide_rot     two of each Sigma's rotations as a 64-bit multiply by
#                   2^(32 - r) (both halves from one IMAD.WIDE)
#   x4_a3           a = T1 + Sigma0 + Maj as one three-way add (T1 = h + W
#                   + K + Sigma1 + Ch by multiply-adds): the a chain three
#                   steps too, at one more integer-pipe instruction a round
#   x4_sigma_last   every addition a multiply-add by `one`, ordered so
#                   that Sigma1 (Sigma0) is added last to a sum ready
#                   before it: the e and a chains three steps, the integer
#                   pipe 10 instructions a round
#   x4_sigma_last_mask  that, with a lane's state taking a block as
#                   h + x * (b < nb), an IMAD, in place of a select
#   x4_stages4      four ring stages in place of two
#   x4_fma_rot      one rotation of each Sigma on the FMA pipe:
#                   rotr(x, r) = x * 2^(32 - r) + umulhi(x, 2^(32 - r)),
#                   an IMAD.HI and an IMAD (2^(32 - r) from `one`)
#   x4_fma_rot_iadd3  that, with every addition a plain add
_X4_ROUND = """      const uint32_t hk = hh * one + wk;
      const uint32_t dhk = d * one + hk;
      const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & bb) ^ (a & c) ^ (bb & c);
      const uint32_t s1ch = s1 * one + ch;
      const uint32_t s0maj = s0 * one + maj;
      hh = g;
      g = f;
      f = e;
      e = dhk + s1 + ch;
      d = c;
      c = bb;
      bb = a;
      a = (s1ch * one + hk) * one + s0maj;
"""
_X4_SIGMAS = _X4_ROUND.split("\n", 2)[2].split("      const uint32_t s1ch")[0]
_X4_SHIFT = """      hh = g;
      g = f;
      f = e;
      e = {e};
      d = c;
      c = bb;
      bb = a;
      a = {a};
"""
_X4_TEXTBOOK = (_X4_ROUND, "      const uint32_t hk = hh + wk;\n" + _X4_SIGMAS
                + "      const uint32_t t1 = hk + s1 + ch;\n"
                + _X4_SHIFT.format(e="d + t1", a="t1 + s0 + maj"))
_X4_EX = (_X4_ROUND, "      const uint32_t hk = hh + wk;\n"
          "      const uint32_t dhk = d + hk;\n" + _X4_SIGMAS
          + "      const uint32_t x = s0 + maj - d;\n"
          + _X4_SHIFT.format(e="dhk + s1 + ch", a="e + x"))
_X4_IADD3 = (_X4_ROUND, _X4_ROUND.replace(" * one", ""))
_X4_SIGMA_LAST = (_X4_ROUND, "      const uint32_t hk = hh * one + wk;\n"
                  "      const uint32_t dhk = d * one + hk;\n" + _X4_SIGMAS
                  + "      const uint32_t t1 = s1 * one + (ch * one + hk);\n"
                  + _X4_SHIFT.format(e="s1 * one + (ch * one + dhk)",
                                     a="s0 * one + (maj * one + t1)"))
_X4_MASK = [("    const bool real = b < nb;\n", "    const uint32_t real = b < nb;\n")] + [
    (f"h[{k}] = real ? h[{k}] + {v} : h[{k}];", f"h[{k}] = {v} * real + h[{k}];")
    for k, v in enumerate(("a", "bb", "c", "d", "e", "f", "g", "hh"))]
_X4_A3 = (_X4_ROUND, "      const uint32_t hk = hh * one + wk;\n"
          "      const uint32_t dhk = d * one + hk;\n" + _X4_SIGMAS
          + "      const uint32_t t1 = (s1 * one + ch) * one + hk;\n"
          + _X4_SHIFT.format(e="dhk + s1 + ch", a="t1 + s0 + maj"))
_X4_WIDE = [
    ("""__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}
""", """__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t rotr_wide(uint32_t x, int r,
                                              uint32_t one) {
  const uint64_t p = (uint64_t)x * (uint64_t)(one << (32 - r));
  return (uint32_t)p ^ (uint32_t)(p >> 32);
}
"""),
    ("rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)",
     "rotr(e, 6) ^ rotr_wide(e, 11, one) ^ rotr_wide(e, 25, one)"),
    ("rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)",
     "rotr(a, 2) ^ rotr_wide(a, 13, one) ^ rotr_wide(a, 22, one)"),
]
_X4_FMA_ROT = [
    ("""__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}
""", """__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

// rotr(x, r) with m = 2^(32 - r): the low half of x * m plus the high
__device__ __forceinline__ uint32_t rotr_fma(uint32_t x, uint32_t m) {
  return x * m + __umulhi(x, m);
}
"""),
    ("  uint32_t h[8] = {0x6a09e667u,",
     "  const uint32_t m7 = one << 7, m10 = one << 10;\n"
     "  uint32_t h[8] = {0x6a09e667u,"),
    ("rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)",
     "rotr(e, 6) ^ rotr(e, 11) ^ rotr_fma(e, m7)"),
    ("rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)",
     "rotr(a, 2) ^ rotr(a, 13) ^ rotr_fma(a, m10)"),
]
PROBES.update({
    "x4_fma_rot": ("sha256.cu", _X4_FMA_ROT),
    "x4_fma_rot_iadd3": ("sha256.cu", [_X4_IADD3] + _X4_FMA_ROT),
    "x4_rounds_only": ("sha256.cu", [(
        "for (int q = 0; q < QUADS; ++q) {\n      uint32_t wk[4];",
        "for (int q = 0; q < 0; ++q) {\n      uint32_t wk[4];")]),
    "x4_e_imad": ("sha256.cu", [("e = dhk + s1 + ch;",
                                 "e = s1ch * one + dhk;")]),
    "x4_iadd3": ("sha256.cu", [_X4_IADD3]),
    "x4_textbook": ("sha256.cu", [_X4_TEXTBOOK]),
    "x4_ex": ("sha256.cu", [_X4_EX]),
    "x4_wide_rot": ("sha256.cu", _X4_WIDE),
    "x4_a3": ("sha256.cu", [_X4_A3]),
    "x4_sigma_last": ("sha256.cu", [_X4_SIGMA_LAST]),
    "x4_sigma_last_mask": ("sha256.cu", [_X4_SIGMA_LAST] + _X4_MASK),
    "x4_stages4": ("sha256.cu", [("int STAGES = 2;", "int STAGES = 4;")]),
})
# the block shape: the tree's one warp against two and four
for _k, _src in (("k2", "verify_cached.cu"), ("k4", "verify8_cached.cu")):
    for _threads, _blocks in ((64, 6), (128, 3)):
        PROBES[f"{_k}_block{_threads}"] = (_src, [
            ("int BLOCK = 32;", f"int BLOCK = {_threads};"),
            ("__launch_bounds__(BLOCK, 12)",
             f"__launch_bounds__(BLOCK, {_blocks})")])
# X1's block of 1, 2 or 8 warps in place of 4 (and the blocks an SM
# must hold for 10,000 lanes in one wave)
for _warps, _blocks in ((1, 10), (2, 5), (8, 2)):
    PROBES[f"x1_warps{_warps}"] = ("build_tables.cu", [
        ("constexpr int WARPS = 4;", f"constexpr int WARPS = {_warps};"),
        ("__launch_bounds__(BLOCK, 3)", f"__launch_bounds__(BLOCK, {_blocks})")])
# X1 with a part cut, for what the other part costs (their tables are
# wrong): the table's 13 affine adds, or A's sqrt chain (x is y's
# canonical value)
PROBES["x1_no_adds"] = ("build_tables.cu", [
    ("for (int e = 2; e < 15; ++e) {", "for (int e = 2; e < 2; ++e) {")])
PROBES["x1_no_sqrt"] = ("build_tables.cu", [(
    """    const bool dec = f26::decompress_xc(xc, f26::fe_load13(y_a + ln, n),
                                        s26 + S_D, s26 + S_SQRTM1);""",
    """    xc = f26::fe_canonical(f26::fe_load13(y_a + ln, n));
    const bool dec = true;""")])
# X1 with the decompressing warp chosen by the block's place on its SM
# (the hardware warp slot %warpid of warp 0, over 4), in place of warp 0
PROBES["x1_dec_rot"] = ("build_tables.cu", [
    ("""  const int t = threadIdx.x;
""", """  const int t = threadIdx.x;
  __shared__ int dec_warp;
  if (t == 0) {
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    dec_warp = (slot >> 2) & 3;
  }
"""),
    ("""  if (t < LANES) {
    const size_t lane = base + t;""", """  if ((t >> 5) == dec_warp) {
    const size_t lane = base + (t & 31);"""),
    ("xs[i * LANES + t] = x.v[i];", "xs[i * LANES + (t & 31)] = x.v[i];")])
# X1 with clock64() stamps a block (its SM, warp 0's hardware slot, its
# start, the end of its decompression, each warp's end), read back by
# x1_read_stamps: where a block's time goes and which blocks share an SM
PROBES["x1_phases"] = ("build_tables.cu", [
    ("""namespace {
""", """__device__ long long g_stamps[4096][8];

extern "C" int x1_read_stamps(long long* host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps,
                                   sizeof(long long) * 8 * blocks);
}

namespace {
"""),
    ("""  const int t = threadIdx.x;
""", """  const int t = threadIdx.x;
  long long* const stamp = g_stamps[blockIdx.x];
  if (t == 0) {
    unsigned sm, slot;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    stamp[0] = clock64();
    stamp[6] = sm;
    stamp[7] = slot;
  }
"""),
    ("""    if (lane < (size_t)n) ok[lane] = dec ? 1 : 0;
  }
""", """    if (lane < (size_t)n) ok[lane] = dec ? 1 : 0;
    if (t == 0) stamp[1] = clock64();
  }
"""),
    ("""  store(15, round_a(p, m, c, r, dz));
}""", """  store(15, round_a(p, m, c, r, dz));
  if ((t & 31) == 0) stamp[2 + (t >> 5)] = clock64();
}""")])
# X1 with the register cap of two blocks an SM (255) in place of three
PROBES["x1_regs255"] = ("build_tables.cu", [
    ("__launch_bounds__(BLOCK, 3)", "__launch_bounds__(BLOCK, 2)")])
# the parent's uncached kernels, X4, X1 and what they include
PARENT_FILES = ("verify_uncached.cu", "verify8_uncached.cu",
                "kernel_common.cuh", "ed25519.cuh", "sha256.cu",
                "build_tables.cu", "fe26.cuh", "rlc.cu")
# files an older REV may lack (headers and X5 came later; --only x5
# needs rlc.cu)
OPTIONAL_PARENT_FILES = ("kernel_common.cuh", "fe26.cuh", "rlc.cu")
# the one-thread X4's schedule, cut for a SASS count without it
X4_NO_SCHEDULE = ("    if (t >= 16) {\n", "    if (false) {\n")
# X4's path shapes: (name, block bucket, lane bucket)
X4_SHAPES = (("part_leaves", 2048, 512), ("gossip_window", 2048, 8),
             ("tx_key_window", 64, 2048))


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
    """The parent's K1/K3, X4 and X1 sources and headers under
    build/ab/parent-REV/, from `git show` unless they are there already
    (the file FILES lists what was extracted). A header REV does not have
    (kernel_common.cuh went in PR 7) is left out."""
    out = OUT / f"parent-{rev}"
    if (out / "FILES").exists():
        return out
    if not (ROOT / ".git").exists():
        raise SystemExit(f"{out} is missing and {ROOT} is no git checkout: "
                         f"run --parent {rev} --extract-only where it is")
    out.mkdir(parents=True, exist_ok=True)
    got = []
    for f in PARENT_FILES:
        proc = subprocess.run(["git", "show", f"{rev}:{CSRC_REL}/{f}"],
                              cwd=ROOT, capture_output=True, text=True)
        if proc.returncode == 0:
            (out / f).write_text(proc.stdout)
            got.append(f)
        elif f not in OPTIONAL_PARENT_FILES:
            raise SystemExit(f"git show {rev}:{CSRC_REL}/{f}: "
                             f"{proc.stderr.strip()}")
    (out / "FILES").write_text("\n".join(got) + "\n")
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


def no_schedule_source(pdir: Path) -> Path:
    """The parent's sha256.cu with its message schedule cut, for a SASS
    count without it (its digests are wrong)."""
    text = (pdir / "sha256.cu").read_text()
    old, new = X4_NO_SCHEDULE
    if text.count(old) != 1:
        raise SystemExit(f"{pdir}/sha256.cu: {old!r} found "
                         f"{text.count(old)} times")
    path = pdir / "sha256_no_schedule.cu"
    path.write_text(text.replace(old, new))
    return path


def x4_entry(lib_path):
    """fn(blocks, nblocks) -> (8, L) state through the C entry
    sha256_blocks of a built X4 library, on the current stream."""
    import torch

    fn = ctypes.CDLL(str(lib_path)).sha256_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(blocks, nblocks):
        lanes = blocks.shape[2]
        state = torch.empty((8, lanes), dtype=torch.uint32,
                            device=blocks.device)
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = fn(blocks.data_ptr(), nblocks.data_ptr(),
                 int(nblocks.dtype == torch.uint16), state.data_ptr(),
                 blocks.shape[0], lanes, stream)
        if err:
            raise RuntimeError(f"{lib_path.name}: cudaError {err}")
        return state
    return run


def x4_ab(torch, cs, dev, x4_libs, smi):
    """The tree's X4 against X4@parent at the hash path's three shapes:
    held against hashlib and the plain version, then timed in turns
    beside both bounds; one warp's cycles a compression; SASS counts."""
    import numpy as np

    from cometbft_tpu_torch.ops import build, cuda_sha256
    from cometbft_tpu_torch.ops import sha256 as osha
    from cometbft_tpu_torch.types import block

    probe = cs.clock_probe(torch)
    cs.emit({"x4": "clock_probe", "card": smi, **probe})
    sass = {"X4": cs.x4_sass_counts(build.BUILD_INFO["sha256.cu"]["path"])}
    for name, so in x4_libs.items():
        sass[name] = cs.x4_sass_counts(so)
    loop = {k: next(lp for lp in sass[k]["loops"] if "per_round" in lp)
            for k in ("X4@parent", "X4@parent_no_schedule")}
    schedule = (loop["X4@parent"]["instructions"]
                - loop["X4@parent_no_schedule"]["instructions"])
    cs.emit({"x4": "sass", **sass, "parent_schedule_instructions": schedule,
             "parent_schedule_share":
                 schedule / loop["X4@parent"]["instructions"]})
    probes = [name for name in x4_libs if name.startswith("x4")]
    runs = {"X4": cuda_sha256.sha256, "X4@parent": x4_entry(
        x4_libs["X4@parent"]), **{p: x4_entry(x4_libs[p]) for p in probes}}
    txs, data = cs.make_hash_block()
    size = block.BLOCK_PART_SIZE_BYTES
    leaves = [b"\x00" + data[i : i + size] for i in range(0, len(data), size)]
    msgs = {"part_leaves": leaves, "gossip_window": leaves[:5],
            "tx_key_window": txs[:2048]}
    wires = {}
    for name, bb, lb in X4_SHAPES:
        blocks, nblocks = osha.pack_messages(msgs[name])
        cs.check((blocks.shape[0], blocks.shape[2]) == (bb, lb),
                 f"X4 {name}: shape {blocks.shape}")
        wires[name] = (blocks, nblocks, torch.from_numpy(blocks).to(dev),
                       torch.from_numpy(nblocks).to(dev))
    states = {k: {} for k in runs}
    wrong = dict.fromkeys(runs, 0)  # lanes != hashlib (probes may differ)
    for kname, fn in runs.items():
        for name, (_, _, b, nb) in wires.items():
            states[kname][name] = fn(b, nb)
            got = osha._digests_from_state(
                states[kname][name].cpu().numpy(), len(msgs[name]))
            wrong[kname] += sum(g != hashlib.sha256(m).digest()
                                for g, m in zip(got, msgs[name]))
    cs.check(not (wrong["X4"] or wrong["X4@parent"]),
             f"X4 != hashlib: {wrong}")
    mismatches = dict.fromkeys(runs, 0)
    for bb in sorted({bb for _, bb, _ in X4_SHAPES}):
        group = [name for name, b_, _ in X4_SHAPES if b_ == bb]
        cat_b = torch.from_numpy(np.concatenate(
            [wires[n][0] for n in group], axis=2)).to(dev)
        cat_nb = torch.from_numpy(np.concatenate(
            [wires[n][1].astype(np.int64) for n in group])).to(dev)
        plain = cuda_sha256.as_int64(osha.sha256_plain(cat_b, cat_nb))
        for kname in runs:
            got = torch.cat([cuda_sha256.as_int64(states[kname][n])
                             for n in group], dim=1)
            mismatches[kname] += int((got != plain).sum())
    cs.emit({"x4": "compare", "shapes": [list(s) for s in X4_SHAPES],
             "lanes_not_hashlib": wrong, "plain_mismatches": mismatches})
    cs.check(not (mismatches["X4"] or mismatches["X4@parent"]),
             f"X4 != plain: {mismatches}")
    one_warp = {k: cs.x4_one_warp(torch, fn, leaves, probe["clock_ghz"],
                                  check_digests=k in ("X4", "X4@parent"))
                for k, fn in runs.items()}
    cs.emit({"x4": "one_warp", **one_warp})
    summary = {}
    for name, bb, _ in X4_SHAPES:
        _, nblocks, b, nb = wires[name]
        ms = {}
        group = ["X4", *probes, "X4@parent"]
        for kname in group + group[::-1]:
            t, out = cs.time_ms(torch, lambda fn=runs[kname]: fn(b, nb),
                                cs.KERNEL_REPS)
            cs.check(kname in probes or torch.equal(
                out.view(torch.int32), states[kname][name].view(torch.int32)),
                     f"{kname} {name}: timed output changed")
            ms.setdefault(kname, []).append(t)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        bound_ms, bound_by = cs.x4_bound(*cuda_sha256.work(nb, bb))
        chain_ms = cs.x4_chain_bound_ms(nb, bb, probe)
        summary[name] = {
            "lanes": len(msgs[name]), "ms": mean, "new_over_parent":
                mean["X4"] / mean["X4@parent"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_bound_ms": chain_ms,
            "share_of_larger_bound": {
                k: max(bound_ms, chain_ms) / v for k, v in mean.items()}}
        cs.emit({"x4": "time", "shape": name, "order": group + group[::-1],
                 "ms_in_turns": ms, **summary[name]})
    cs.emit({"x4_summary": summary, "card": smi})


def x1_entry(lib_path, consts):
    """fn(y_a, sign_a) -> (table (16, 4, 20, M), ok (M,)) through the C
    entry ed25519_build_tables of a built X1 library, on the current
    stream."""
    import torch

    fn = ctypes.CDLL(str(lib_path)).ed25519_build_tables
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(y_a, sign_a):
        m = y_a.shape[1]
        table = torch.empty((16, 4, 20, m), dtype=torch.int32,
                            device=y_a.device)
        ok = torch.empty(m, dtype=torch.bool, device=y_a.device)
        stream = torch.cuda.current_stream(y_a.device).cuda_stream
        err = fn(y_a.data_ptr(), sign_a.data_ptr(), consts.data_ptr(),
                 table.data_ptr(), ok.data_ptr(), m, stream)
        if err:
            raise RuntimeError(f"{lib_path.name}: cudaError {err}")
        return table, ok
    return run


X1_SIZES = (10_000, 5_000)  # the slice path's builds, a light key group


def x1_phases(lib_path, n, probe):
    """The x1_phases probe's stamps of its last launch at n lanes: each
    block's decompression (start to warp 0's end of it) and table (that to
    the last warp's end) in cycles, by how many blocks shared its SM, the
    longest span of an SM's blocks, and how often co-resident blocks'
    warp 0 sat on the same slot modulo 4 (SM clocks are not synchronised,
    so only cycles on one SM are compared)."""
    import collections
    import statistics

    blocks = (n + 31) // 32
    buf = (ctypes.c_longlong * (8 * blocks))()
    fn = ctypes.CDLL(str(lib_path)).x1_read_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if fn(ctypes.addressof(buf), blocks):
        raise RuntimeError("x1_read_stamps failed")
    rows = [buf[8 * b: 8 * b + 8] for b in range(blocks)]
    by_sm = collections.defaultdict(list)
    for r in rows:
        by_sm[r[6]].append(r)
    out = {}
    for k in sorted({len(v) for v in by_sm.values()}):
        group = [r for v in by_sm.values() if len(v) == k for r in v]
        dec = [r[1] - r[0] for r in group]
        table = [max(r[2:6]) - r[1] for r in group]
        span = [max(max(r[2:6]) for r in v) - min(r[0] for r in v)
                for v in by_sm.values() if len(v) == k]
        same = sum(len({r[7] % 4 for r in v}) < len(v)
                   for v in by_sm.values() if len(v) == k)
        out[f"{k}_blocks_an_sm"] = {
            "sms": sum(len(v) == k for v in by_sm.values()),
            "dec_cycles_median": statistics.median(dec),
            "dec_cycles_max": max(dec),
            "table_cycles_median": statistics.median(table),
            "table_cycles_max": max(table),
            "sm_span_cycles_max": max(span),
            "sms_with_warp0_slots_sharing_mod4": same}
    out["clock_ghz"] = probe["clock_ghz"]
    return out


def x1_ab(torch, cs, dev, x1_libs, smi):
    """The tree's X1 against X1@parent and the x1 probes: held against the
    plain version at 1,000 lanes and at X1_SIZES, then timed in turns at
    X1_SIZES beside the throughput and chain bounds."""
    from cometbft_tpu_torch.ops import build, cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

    probe = cs.clock_probe(torch)
    tree_lib = build.BUILD_INFO["build_tables.cu"]["path"]
    sass = {"X1": cs.x1_sass(tree_lib, probe),
            **{k: cs.x1_sass(so, probe) for k, so in x1_libs.items()}}
    chain_ms = cs.x1_lane_ms(sass["X1"], probe)
    cs.emit({"x1": "sass", **sass, "chain_bound_ms": chain_ms, "card": smi,
             "warp_issue_ms": cs.x1_lane_ms(sass["X1"], probe, "issue_cycles"),
             "clock_probe": {k: v for k, v in probe.items() if k != "sass"}})
    consts = cuda_verify._consts(dev)
    runs = {"X1": x1_entry(tree_lib, consts),
            **{k: x1_entry(so, consts) for k, so in x1_libs.items()}}
    probes = [k for k in x1_libs if k.startswith("x1")]
    with get_context("spawn").Pool(cs.WORKERS) as pool:
        pks, msgs, sigs, _ = cs.make_lanes(pool)
    buf, _ = ov.pack_bytes(pks, msgs, sigs)
    wire = torch.from_numpy(buf).to(dev)
    summary = {}
    for n in (cs.N_RAGGED,) + X1_SIZES:
        cols = torch.arange(n, device=dev) % cs.N_LANES
        a = ov.unpack_on_device(wire[:, cols])
        y_a, sign_a = a["y_a"], a["sign_a"]
        plain = curve.build_pubkey_tables(y_a, sign_a)
        outs = {k: fn(y_a, sign_a) for k, fn in runs.items()}
        torch.cuda.synchronize()
        mismatches = {k: sum(int((o != p).sum()) for o, p in zip(out, plain))
                      for k, out in outs.items()}
        cs.emit({"x1": "compare", "lanes": n, "mismatches": mismatches})
        cs.check(not (mismatches["X1"] or mismatches["X1@parent"]),
                 f"X1 != plain: {mismatches}")
        if n == cs.N_RAGGED:
            continue
        group = ["X1", *probes, "X1@parent"]
        ms = {}
        for name in group + group[::-1]:
            t, out = cs.time_ms(torch, lambda fn=runs[name]: fn(y_a, sign_a)[0],
                                cs.KERNEL_REPS)
            cs.check(name in probes or torch.equal(out, outs[name][0]),
                     f"{name} at {n}: timed output changed")
            ms.setdefault(name, []).append(t)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        bound_ms, bound_by = cs.bound(cuda_verify, "build_pubkey_tables", n)
        summary[n] = {
            "ms": mean, "new_over_parent": mean["X1"] / mean["X1@parent"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_bound_ms": chain_ms, "share_of_larger_bound": {
                k: max(bound_ms, chain_ms) / v for k, v in mean.items()}}
        cs.emit({"x1": "time", "lanes": n, "order": group + group[::-1],
                 "ms_in_turns": ms, **summary[n]})
        if "x1_phases" in x1_libs:
            runs["x1_phases"](y_a, sign_a)
            torch.cuda.synchronize()
            cs.emit({"x1": "phases", "lanes": n,
                     **x1_phases(x1_libs["x1_phases"], n, probe)})
    cs.emit({"x1_summary": summary, "card": smi})


# X5@parent (the four-launch design) with clock64() stamps in its
# one-block finish: each warp's lane 0 stamps its start, the end of its
# share of the ok-byte scan, the end of its windows' join of runs, the
# barrier after it, the end of its Horner walk ([b]B on warp 2), the
# barrier after that, and warp 0 the end of the cofactor test
X5_PARENT_PHASES = [
    ("""namespace {
""", """__device__ long long g_x5_stamps[32][8];

extern "C" int x5_read_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_x5_stamps, sizeof(g_x5_stamps));
}

namespace {
"""),
    ("""  __shared__ int bad;
  stage_consts26(sm, a.consts);
""", """  __shared__ int bad;
  long long* const stamp = g_x5_stamps[threadIdx.x >> 5];
  const bool lead = (threadIdx.x & 31) == 0;
  if (lead) stamp[0] = clock64();
  stage_consts26(sm, a.consts);
"""),
    ("""    if (a.okb[p] == 0) bad = 1;
""", """    if (a.okb[p] == 0) bad = 1;
  if (lead) stamp[1] = clock64();
"""),
    ("""    if (live) fe_st(a.sums + ((size_t)(s.s0 + j) * 4 + c) * NL, acc);
  }
  __syncthreads();
""", """    if (live) fe_st(a.sums + ((size_t)(s.s0 + j) * 4 + c) * NL, acc);
  }
  if (lead) stamp[2] = clock64();
  __syncthreads();
  if (lead) stamp[3] = clock64();
"""),
    ("""    if ((threadIdx.x & 31) < 4) fe_st(part[warp][c], acc);
""", """    if ((threadIdx.x & 31) < 4) fe_st(part[warp][c], acc);
    if (lead) stamp[4] = clock64();
"""),
    ("""    if ((threadIdx.x & 31) < 4) fe_st(part[2][c], sb);
""", """    if ((threadIdx.x & 31) < 4) fe_st(part[2][c], sb);
    if (lead) stamp[4] = clock64();
"""),
    ("""  __syncthreads();

  if (warp == 0) {
""", """  __syncthreads();
  if (lead) stamp[5] = clock64();

  if (warp == 0) {
"""),
    ("""    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
""", """    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
    if (lead) stamp[6] = clock64();
""")]


# X5 with clock64() stamps in its join and finish: each join block's
# lane 0 stamps its start and end (row = the block: a window, or [b]B
# last); x5_finish's warps (rows 126, 127) their start, the end of the
# staging and the ok-byte scan, the end of the Horner walk, the barrier
# after it, and warp 0 the end of the cofactor test
X5_PHASES = [
    ("""namespace {
""", """__device__ long long g_x5_stamps[128][8];

extern "C" int x5_read_stamps(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_x5_stamps, sizeof(g_x5_stamps));
}

namespace {
"""),
    ("""  const int win = blockIdx.x;
""", """  const int win = blockIdx.x;
  long long* const stamp = g_x5_stamps[win];
  if (threadIdx.x == 0) stamp[0] = clock64();
"""),
    ("""      d_st(a.sums + ((size_t)(wt + 1) * 4 + c) * NL, sb);
""", """      d_st(a.sums + ((size_t)(wt + 1) * 4 + c) * NL, sb);
      if (threadIdx.x == 0) stamp[1] = clock64();
"""),
    ("""  if (warp == 0) d_st(a.sums + ((size_t)win * 4 + c) * NL, w);
""", """  if (warp == 0) d_st(a.sums + ((size_t)win * 4 + c) * NL, w);
  if (threadIdx.x == 0) stamp[1] = clock64();
"""),
    ("""  if (threadIdx.x == 0) bad = 0;
""", """  long long* const stamp = g_x5_stamps[126 + (threadIdx.x >> 5)];
  const bool lead = (threadIdx.x & 31) == 0;
  if (lead) stamp[0] = clock64();
  if (threadIdx.x == 0) bad = 0;
"""),
    ("""    if (a.okb[i] == 0) bad = 1;
""", """    if (a.okb[i] == 0) bad = 1;
  if (lead) stamp[1] = clock64();
"""),
    ("""    d_st(part[warp][c], acc);
""", """    d_st(part[warp][c], acc);
    if (lead) stamp[2] = clock64();
"""),
    ("""  __syncthreads();
  if (warp == 0) {
    fd t = """, """  __syncthreads();
  if (lead) stamp[3] = clock64();
  if (warp == 0) {
    fd t = """),
    ("""    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
""", """    if (threadIdx.x == 0) a.out[0] = (ident && bad == 0) ? 1 : 0;
    if (lead) stamp[4] = clock64();
""")]


def x5_phases(lib_path, windows: int, probe) -> dict:
    """The x5_phases stamps of its last launch: the join stage's longest
    window and its [b]B block, and the finish's staging and ok-byte scan,
    Horner A (warp 0) and R (warp 1), the last adds, the cofactor and the
    test (warp 0), and its span, in cycles and microseconds."""
    buf = (ctypes.c_longlong * (128 * 8))()
    fn = ctypes.CDLL(str(lib_path)).x5_read_stamps
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.addressof(buf)):
        raise RuntimeError("x5_read_stamps failed")
    st = [buf[8 * w: 8 * w + 8] for w in range(128)]
    f0, f1 = st[126], st[127]
    cycles = {
        "join_window_max": max(st[w][1] - st[w][0] for w in range(windows)),
        "join_b_base": st[windows][1] - st[windows][0],
        "stage_scan": max(f0[1] - f0[0], f1[1] - f1[0]),
        "horner_a": f0[2] - f0[1], "horner_r": f1[2] - f1[1],
        "cofactor_test": f0[4] - f0[3],
        "finish": f0[4] - min(f0[0], f1[0])}
    ghz = probe["clock_ghz"]
    return {"cycles": cycles,
            "us": {k: v / (ghz * 1e3) for k, v in cycles.items()}}


def patched_source(src: Path, subs, name: str, out: Path) -> Path:
    """``src`` with each (old, new) of ``subs`` applied once, written to
    ``out``/NAME.cu (beside a parent's source, so that its own headers
    are found first)."""
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} found {text.count(old)} "
                             f"times in {src}")
        text = text.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name.replace('@', '_')}.cu"
    path.write_text(text)
    return path


def x5_parent_entry(lib_path):
    """fn(inp, events=None) -> (A's window sums, R's, the pre-cofactor
    total, the bool) through the four-launch design's C entry
    x5_rlc_stage and its scratch layout, as
    cuda_rlc.rlc_equation(parts=True) returns them; ``events``, five CUDA
    events, are recorded around its four stages."""
    import torch

    from cometbft_tpu_torch.ops import cuda_verify, rlc

    fn = ctypes.CDLL(str(lib_path)).x5_rlc_stage
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(inp, events=None):
        y_a, y_r = inp["y_a"], inp["y_r"]
        dev = y_a.device
        c_a, c_r = inp["c_a"], inp["c_r"]
        na, nr = y_a.shape[1], y_r.shape[1]
        wa, wr = rlc.windows(c_a, rlc.A_BITS), rlc.windows(c_r, rlc.R_BITS)
        s = min(32, 1 << (c_a - 1), 1 << (c_r - 1))
        ka, kr = (1 << (c_a - 1)) // s, (1 << (c_r - 1)) // s
        nb = wa * (1 << (c_a - 1)) + wr * (1 << (c_r - 1))
        i32 = torch.int32
        pts = torch.empty((na + nr, 3, 10), dtype=i32, device=dev)
        okb = torch.empty(na + nr, dtype=torch.uint8, device=dev)
        buckets = torch.empty((nb, 4, 10), dtype=i32, device=dev)
        runs = torch.empty((wa * ka + wr * kr, 2, 4, 10), dtype=i32,
                           device=dev)
        sums = torch.empty((wa + wr + 1, 4, 10), dtype=i32, device=dev)
        out = torch.empty(1, dtype=torch.uint8, device=dev)
        ptrs = [t.data_ptr() for t in (
            y_a, inp["sign_a"], *inp["plan_a"], y_r, inp["sign_r"],
            *inp["plan_r"], inp["b_bytes"], cuda_verify._consts(dev),
            cuda_verify._base_table8_26(dev), pts, okb, buckets, runs, sums,
            out)]
        ints = [na, c_a, wa, nr, c_r, wr, s]
        args = ((ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int * len(ints))(*ints))
        stream = torch.cuda.current_stream(dev)
        for i in range(4):
            if events is not None:
                events[i].record(stream)
            err = fn(*args, i, stream.cuda_stream)
            if err:
                raise RuntimeError(f"{lib_path.name}: cudaError {err}")
        if events is not None:
            events[4].record(stream)
        pts13 = torch.stack([sums & 8191, sums >> 13], dim=-1).reshape(
            wa + wr + 1, 4, 20).permute(1, 2, 0)
        return (pts13[:, :, :wa], pts13[:, :, wa:wa + wr], pts13[:, :, -1],
                out[0] != 0)
    return run


def x5_parent_phases(lib_path, warps: int, probe) -> dict:
    """The X5@parent_phases stamps of its last launch: each phase of the
    finish in cycles (the ok scan and the join of runs, the longest warp;
    Horner A on warp 0, Horner R on warp 1, [b]B on warp 2, each from the
    barrier; the last adds, the cofactor and the test on warp 0) and the
    finish's whole span, also in microseconds at the probe's clock."""
    buf = (ctypes.c_longlong * (32 * 8))()
    fn = ctypes.CDLL(str(lib_path)).x5_read_stamps
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.addressof(buf)):
        raise RuntimeError("x5_read_stamps failed")
    st = [buf[8 * w: 8 * w + 8] for w in range(warps)]
    cycles = {
        "ok_scan": max(r[1] - r[0] for r in st),
        "join_runs": max(r[2] - r[1] for r in st),
        "horner_a": st[0][4] - st[0][3],
        "horner_r": st[1][4] - st[1][3],
        "b_base": st[2][4] - st[2][3],
        "cofactor_test": st[0][6] - st[0][5],
        "finish": st[0][6] - min(r[0] for r in st)}
    ghz = probe["clock_ghz"]
    return {"cycles": cycles,
            "us": {k: v / (ghz * 1e3) for k, v in cycles.items()},
            "warps": warps}


def x5_sass(lib_path, cs) -> dict:
    """Each X5 kernel's SASS instructions, and its loops' instructions,
    64-bit multiply-adds, shuffles and dependent depth."""
    report = cs.sass_report(lib_path, "x5_")
    return {name: {"instructions": r["instructions"], "loops": [
        {k: lp[k] for k in ("instructions", "imad_wide", "depth")}
        | {"shfl": lp["opcodes"].get("SHFL", 0)} for lp in r["loops"]]}
        for name, r in report.items()}


def x5_ab(torch, cs, dev, x5_libs, smi):
    """The tree's X5 against X5@parent on chip_smoke's seeded rlc lanes
    (the commit's 10,000 and the 40,000-lane catch-up, folded with
    chip_smoke's seed): both held against the plain version as encodings,
    then timed in turns (X5, X5@parent, X5@parent, X5) at both shapes,
    stage by stage, beside the bounds of cuda_rlc.work,
    chip_smoke.chain_products (the yardstick) and chip_smoke.design_chain
    (X5's own chain); the phase clocks of both."""
    import numpy as np

    from cometbft_tpu_torch.ops import build, cuda_rlc, rlc
    from cometbft_tpu_torch.ops import verify as ov

    probe = cs.clock_probe(torch)
    sq = cs.x1_sass(build.BUILD_INFO["build_tables.cu"]["path"],
                    probe)["squaring"]
    ghz = probe["clock_ghz"]
    tree_lib = build.BUILD_INFO["rlc.cu"]["path"]
    cs.emit({"x5": "sass", "X5": x5_sass(tree_lib, cs),
             **{k: x5_sass(so, cs) for k, so in x5_libs.items()},
             "product_cycles": sq["chain_cycles"],
             "product_issue_cycles": sq["issue_cycles"], "clock_ghz": ghz,
             "issue_cycles": probe["issue_cycles"],
             "latency_cycles_imad_wide": probe["latency_cycles_imad_wide"],
             "card": smi})
    with get_context("spawn").Pool(cs.WORKERS) as pool:
        vals, _, commit = cs.make_commit(pool)
        commits, _ = cs.make_catchup_commits(pool, vals, commit)
    rng = np.random.default_rng(cs.RLC_SEED)
    parent = x5_parent_entry(x5_libs["X5@parent"])
    tree_probe = cuda_rlc.stage_entry(ctypes.CDLL(str(x5_libs["x5_phases"])))
    runs = {"X5": lambda inp, events=None: cuda_rlc.rlc_equation(
                **inp, parts=True, stage_events=events),
            "X5@parent": parent}
    stage_names = {"X5": cuda_rlc.STAGES,
                   "X5@parent": ("decompress", "buckets", "runs", "finish")}
    summary = {}
    for lanes in (cs.commit_lanes(vals, [commit]),
                  cs.commit_lanes(vals, [commits[h]
                                         for h in cs.RLC_HEIGHTS])):
        buf, host_ok = ov.pack_bytes(*lanes)
        folded = rlc.fold(buf, host_ok, rng.bytes(16 * int(host_ok.sum())))
        inp = rlc.to_device(rlc.launch_inputs(*folded), dev)
        shape = "%dx%d" % (inp["y_a"].shape[1], inp["y_r"].shape[1])
        plain = rlc._rlc_parts(**inp)
        compare = {k: cs.x5_compare(rlc, inp, fn(inp), plain)
                   for k, fn in runs.items()}
        cs.emit({"x5": "compare", "lanes": len(lanes[0]), "shape": shape,
                 **compare})
        cs.check(all(compare[k]["mismatches"] == 0 and compare[k]["x5"]
                     for k in ("X5", "X5@parent")),
                 f"X5 != plain at {shape}: {compare}")
        group = list(runs)
        ms = {}
        for name in group + group[::-1]:
            t, _ = cs.time_ms(torch, lambda fn=runs[name]: fn(inp)[3],
                              cs.KERNEL_REPS)
            ms.setdefault(name, []).append(t)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        stages = {}
        for name, fn in runs.items():
            samples = []
            for _ in range(cs.RUNS):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(stage_names[name]) + 1)]
                fn(inp, ev)
                ev[-1].synchronize()
                samples.append([ev[i].elapsed_time(ev[i + 1])
                                for i in range(len(ev) - 1)])
            stages[name] = dict(zip(stage_names[name], (
                statistics.median(s) for s in zip(*samples))))
        plans = ([a.cpu().numpy() for a in inp["plan_a"]],
                 [a.cpu().numpy() for a in inp["plan_r"]],
                 inp["c_a"], inp["c_r"])
        ops, nbytes = cuda_rlc.work(*plans)
        ops_ms = 1e3 * ops / cs.PEAK_OPS_PER_S
        bytes_ms = 1e3 * nbytes / cs.PEAK_BYTES_PER_S
        products = cs.chain_products(*plans)
        chain_ms = products * sq["chain_cycles"] / (ghz * 1e6)
        larger = max(ops_ms, bytes_ms, chain_ms)
        design = cs.design_chain(*plans)
        design_ms = design["total"] * sq["chain_cycles"] / (ghz * 1e6)
        summary[shape] = {
            "ms": mean, "new_over_parent": mean["X5"] / mean["X5@parent"],
            "stage_ms": stages, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "chain_products": products, "chain_bound_ms": chain_ms,
            "design_chain": design, "design_chain_ms": design_ms,
            "warp_issue_ms": products * sq["issue_cycles"] / (ghz * 1e6),
            "share_of_larger_bound": {k: larger / v
                                      for k, v in mean.items()},
            "share_of_design_bound": {
                k: max(ops_ms, bytes_ms, design_ms) / v
                for k, v in mean.items()}}
        cs.emit({"x5": "time", "lanes": len(lanes[0]), "shape": shape,
                 "order": group + group[::-1], "ms_in_turns": ms,
                 **summary[shape]})
        wa = rlc.windows(inp["c_a"], rlc.A_BITS)
        wr = rlc.windows(inp["c_r"], rlc.R_BITS)
        sums, out = cuda_rlc.launch(tree_probe, **inp)
        torch.cuda.synchronize()
        cs.check(bool(out[0]), f"x5_phases at {shape}: the equation failed")
        cs.emit({"x5": "phases", "version": "X5", "shape": shape,
                 **x5_phases(x5_libs["x5_phases"], wa + wr, probe)})
        lib = x5_libs["X5@parent_phases"]
        x5_parent_entry(lib)(inp)
        torch.cuda.synchronize()
        warps = max(3, (wa + 7) // 8 + (wr + 7) // 8)
        cs.emit({"x5": "phases", "version": "X5@parent", "shape": shape,
                 **x5_parent_phases(lib, warps, probe)})
    cs.emit({"x5_summary": summary, "card": smi})


def verify_ab(torch, cs, dev, entries, parents, sizes, smi):
    """K1-K4 and their variants: held against the plain versions, then
    timed in turns at each size."""
    from cometbft_tpu_torch.ops import cuda_verify, curve
    from cometbft_tpu_torch.ops import verify as ov

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="3334,6667,10000")
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--parent", metavar="REV",
                    help="also time K1, K3, X4 and X1 of commit REV")
    ap.add_argument("--only", choices=("verify", "x4", "x1", "x5"),
                    help="run only the verify kernels', X4's, X1's or X5's "
                         "part")
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
    from cometbft_tpu_torch.ops import build, cuda_verify

    sizes = [int(x) for x in args.sizes.split(",")]
    variants = dict(v.split("=", 1) for v in args.variants)
    for name in variants:
        if not name.startswith(("k1", "k2", "k3", "k4")):
            raise SystemExit(f"{name}: a variant's name starts with k1-k4")
    x4_probes, x1_probes = {}, {}
    for name in args.probe:
        if name.startswith("x4"):
            x4_probes[name] = probe_source(name, build.CSRC)
        elif name.startswith("x1"):
            x1_probes[name] = probe_source(name, build.CSRC)
        else:
            variants[name] = probe_source(name, build.CSRC)
    for part, probes in (("x4", x4_probes), ("x1", x1_probes), ("x5", {})):
        if (probes or args.only == part) and not (
                args.parent and args.only in (None, part)):
            raise SystemExit(f"{part}'s part (--only {part}, an {part} "
                             "probe) needs --parent REV")
    parents, x4_sources, x1_sources, x5_sources = [], {}, {}, {}
    if args.parent:
        pdir = parent_sources(args.parent)
        if args.only in (None, "verify"):
            variants["K1@parent"] = pdir / "verify_uncached.cu"
            variants["K3@parent"] = pdir / "verify8_uncached.cu"
            parents = ["K1@parent", "K3@parent"]
        if args.only in (None, "x4"):
            x4_sources = {"X4@parent": pdir / "sha256.cu",
                          "X4@parent_no_schedule": no_schedule_source(pdir),
                          **x4_probes}
        if args.only in (None, "x1"):
            x1_sources = {"X1@parent": pdir / "build_tables.cu", **x1_probes}
        if args.only == "x5":
            x5_sources = {"X5@parent": pdir / "rlc.cu",
                          "X5@parent_phases": patched_source(
                              pdir / "rlc.cu", X5_PARENT_PHASES,
                              "X5@parent_phases", pdir),
                          "x5_phases": patched_source(
                              build.CSRC / "rlc.cu", X5_PHASES, "x5_phases",
                              OUT)}
    if args.only in ("x4", "x1", "x5") and variants:
        raise SystemExit(f"--only {args.only} takes no verify variants")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.emit({"card": smi, "parent": args.parent})
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if args.only == "x4":
        build.load_all(["sha256.cu"])
    elif args.only == "x1":
        build.load_all(["build_tables.cu"])
    elif args.only != "x5":
        cuda_verify._entries()
    others = {**variants, **x4_sources, **x1_sources, **x5_sources}
    with ThreadPoolExecutor(max(1, len(others)) + 1) as pool:
        tree = (pool.submit(build.load_all, ["rlc.cu", "build_tables.cu"])
                if args.only == "x5" else None)
        built = list(pool.map(lambda kv: nvcc(build, build.CSRC, *kv),
                              others.items()))
        if tree is not None:
            tree.result()
    cs.emit({"build_s": time.perf_counter() - t0,
             "tree": {k: v for info in build.BUILD_INFO.values()
                      for k, v in build.ptxas_usage(info["ptxas"]).items()},
             "tree_nvcc_s": {k: v["seconds"]
                             for k, v in build.BUILD_INFO.items()},
             "variants": {n: {"nvcc_s": s, "ptxas": u}
                          for n, _, s, u in built}})
    entries = {name: bind(name, ctypes.CDLL(str(so)))
               for name, so, _, _ in built if name in variants}
    x4_libs = {name: so for name, so, _, _ in built if name in x4_sources}
    x1_libs = {name: so for name, so, _, _ in built if name in x1_sources}
    x5_libs = {name: so for name, so, _, _ in built if name in x5_sources}
    if args.only in (None, "verify"):
        verify_ab(torch, cs, dev, entries, parents, sizes, smi)
    if x4_sources:
        x4_ab(torch, cs, dev, x4_libs, smi)
    if x1_sources:
        x1_ab(torch, cs, dev, x1_libs, smi)
    if x5_sources:
        x5_ab(torch, cs, dev, x5_libs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
