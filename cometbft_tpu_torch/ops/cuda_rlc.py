"""Wrapper of X5, the hand-written RLC batch-equation kernel (csrc/rlc.cu).

The counterpart of cometbft_tpu/ops/rlc.py ``_rlc_kernel``, with its
array contract: for each side (A, then R) the ``(20, n)`` int32 y limbs,
``(n,)`` signs and the plan ``(perm, sign, starts, ends)`` of
ops/rlc.plan_msm, ``(W, n)`` and ``(W, m)`` int32; ``b_bytes`` ``(32, 1)``
int32; the window widths ``c_a``, ``c_r``. One bool out.

A CPU tensor goes to the plain PyTorch version (ops.rlc._rlc_parts). A
CUDA tensor launches X5's six kernels (``STAGES``) on the current stream
or raises: there is no fallback. Inputs are checked for dtype, shape,
device and contiguity, scratch and outputs are allocated here with
``torch.empty``, ``LAUNCHES`` counts X5's runs (six kernel launches
each, and nothing else) and ``LAUNCH_SHAPES`` counts them by (A bucket, R
bucket).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from . import build, cuda_verify, rlc
from .field import NLIMB

LAUNCHES = {"rlc": 0}
LAUNCH_SHAPES: dict[str, dict[tuple[int, int], int]] = {"rlc": {}}
SOURCES = {"rlc": "rlc.cu"}
# X5's launches in order, as stage_events times them
STAGES = ("decompress", "buckets", "runs", "groups", "join", "finish")
DECOMPRESS_BLOCK = 128  # x5_decompress's threads a block: one ok byte each
_counts_lock = threading.Lock()

NL26 = NLIMB // 2  # 26-bit limbs of fe26.cuh
RUN_BUCKETS = 16  # buckets a run of stage (c), at most
GROUP_RUNS = 8  # runs a group of stage (d), at most
# A field product on fe26.cuh: 10 x 10 32-bit multiply-adds, two
# operations each (chip_smoke's int32 rate counts a multiply-add as two)
MULADDS_PER_PRODUCT = 100


def reset_launches() -> None:
    with _counts_lock:
        LAUNCHES["rlc"] = 0
        LAUNCH_SHAPES["rlc"].clear()


def run_buckets(c_a: int, c_r: int) -> int:
    """S, the buckets of one run of stage (c): a power of two dividing
    both sides' bucket counts m = 2^(c-1)."""
    return min(RUN_BUCKETS, 1 << (c_a - 1), 1 << (c_r - 1))


def group_runs(c_a: int, c_r: int) -> int:
    """F, the runs of one group of stage (d): a power of two dividing
    both sides' runs a window m / S."""
    s = run_buckets(c_a, c_r)
    return min(GROUP_RUNS, (1 << (c_a - 1)) // s, (1 << (c_r - 1)) // s)


def work(plan_a, plan_r, c_a: int, c_r: int) -> tuple[int, int]:
    """(operations, bytes) of one launch for the throughput bound, from
    this launch's numpy plans: the field products the function needs, at
    ops/rlc.op_ledger's unit costs (an add 9, a doubling 8, a
    decompression 265) and MULADDS_PER_PRODUCT multiply-adds each, and
    the inputs read once (y limbs, signs, both plans, b) and the byte
    written. Needed: a decompression for each point the sums read (a lane
    with a nonzero digit in some window; pad lanes, of scalar 0, are
    never read), an add for each nonzero digit and 2m for each window's
    running sums, Horner's doublings and adds, [b]B's 32 adds, the two
    that join the sides and the cofactor's three doublings. op_ledger is
    the reference's static count, which sums every slot of the padded
    buckets."""
    adds, dbls, points = 32 + 2, 3, 0
    nbytes = 1 + 4 * 32
    for plan, c, nbits in ((plan_a, c_a, rlc.A_BITS),
                           (plan_r, c_r, rlc.R_BITS)):
        perm, _, starts, ends = plan
        w, n = perm.shape
        m = 1 << (c - 1)
        read = np.zeros(n, bool)
        for j in range(w):
            read[perm[j, starts[j, 0]:ends[j, -1]]] = True
        points += int(read.sum())
        adds += int((ends[:, -1] - starts[:, 0]).sum()) + 2 * m * w + w - 1
        dbls += (w - 1) * c
        nbytes += 4 * (NLIMB * n + n + 2 * w * n + 2 * w * m)
    products = 9 * adds + 8 * dbls + 265 * points
    return 2 * MULADDS_PER_PRODUCT * products, nbytes


def stage_entry(lib):
    """x5_rlc_stage of a loaded X5 library, with its argtypes."""
    stage = lib.x5_rlc_stage
    stage.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    stage.restype = ctypes.c_int
    return stage


@lru_cache(maxsize=None)
def _entries():
    return stage_entry(build.load_all([SOURCES["rlc"]])["rlc"])


def _check(name, t, shape, device) -> None:
    cuda_verify._check(name, t, torch.int32, shape, device)


def _check_side(tag, y, sign, plan, c, nbits, device) -> tuple[int, int]:
    if not isinstance(c, int) or not 4 <= c <= 12:
        raise ValueError(f"c_{tag}: {c!r}, expected an int in [4, 12]")
    if not isinstance(y, torch.Tensor) or y.dim() != 2:
        raise ValueError(f"y_{tag}: expected a (20, n) tensor")
    n = y.shape[-1]
    w, m = rlc.windows(c, nbits), 1 << (c - 1)
    if n < 8 or n & (n - 1):
        raise ValueError(f"y_{tag}: {n} lanes, expected a power of two >= 8")
    _check(f"y_{tag}", y, (NLIMB, n), device)
    _check(f"sign_{tag}", sign, (n,), device)
    if len(plan) != 4:
        raise ValueError(f"plan_{tag}: expected (perm, sign, starts, ends)")
    for key, t, shape in zip(rlc.PLAN_KEYS, plan,
                             ((w, n), (w, n), (w, m), (w, m))):
        _check(f"plan_{tag}.{key}", t, shape, device)
    return n, w


def rlc_equation(y_a, sign_a, plan_a, y_r, sign_r, plan_r, b_bytes, *,
                 c_a: int, c_r: int, parts: bool = False, stage_events=None):
    """X5: the batch equation's bool (a 0-d tensor) on these launch inputs
    (ops.rlc.launch_inputs on a device). With ``parts`` it returns
    (A's window sums (4, 20, Wa), R's (4, 20, Wr), the pre-cofactor
    total (4, 20), the bool), points as lazy 13-bit limbs (the kernel's
    26-bit limbs split in two), as ops.rlc._rlc_parts returns them.
    ``stage_events``, seven CUDA events, are recorded before each of the
    six kernels (``STAGES``) and after the last."""
    device = y_a.device
    na, wa = _check_side("a", y_a, sign_a, plan_a, c_a, rlc.A_BITS, device)
    nr, wr = _check_side("r", y_r, sign_r, plan_r, c_r, rlc.R_BITS, device)
    _check("b_bytes", b_bytes, (32, 1), device)
    if device.type == "cpu":
        out = rlc._rlc_parts(y_a, sign_a, plan_a, y_r, sign_r, plan_r,
                             b_bytes, c_a=c_a, c_r=c_r)
        return out if parts else out[3]
    cuda_verify._cuda_device(device)
    sums, out = launch(_entries(), y_a, sign_a, plan_a, y_r, sign_r, plan_r,
                       b_bytes, c_a=c_a, c_r=c_r, stage_events=stage_events)
    with _counts_lock:
        LAUNCHES["rlc"] += 1
        shapes = LAUNCH_SHAPES["rlc"]
        shapes[(na, nr)] = shapes.get((na, nr), 0) + 1
    return split_parts(sums, out, c_a, c_r) if parts else out[0] != 0


def split_parts(sums, out, c_a: int, c_r: int):
    """(A's window sums (4, 20, Wa), R's (4, 20, Wr), the pre-cofactor
    total (4, 20), the bool) from X5's sums and output byte, points as
    lazy 13-bit limbs (each 26-bit limb split in two)."""
    wa, wr = rlc.windows(c_a, rlc.A_BITS), rlc.windows(c_r, rlc.R_BITS)
    pts13 = torch.stack([sums & 8191, sums >> 13], dim=-1).reshape(
        wa + wr + 2, 4, NLIMB).permute(1, 2, 0)
    return (pts13[:, :, :wa], pts13[:, :, wa:wa + wr], pts13[:, :, wa + wr],
            out[0] != 0)


def launch(stage, y_a, sign_a, plan_a, y_r, sign_r, plan_r, b_bytes, *,
           c_a: int, c_r: int, stage_events=None):
    """X5's six launches through the C entry ``stage`` (x5_rlc_stage of
    a library built from csrc/rlc.cu or a probe of it) on checked CUDA
    inputs: (the sums (Wa + Wr + 2, 4, 10) in 26-bit limbs, the output
    byte), counting nothing; a launch error raises."""
    device = y_a.device
    na, nr = y_a.shape[1], y_r.shape[1]
    wa, wr = rlc.windows(c_a, rlc.A_BITS), rlc.windows(c_r, rlc.R_BITS)
    s, f = run_buckets(c_a, c_r), group_runs(c_a, c_r)
    ka, kr = (1 << (c_a - 1)) // s, (1 << (c_r - 1)) // s
    nb = wa * (1 << (c_a - 1)) + wr * (1 << (c_r - 1))
    pts = torch.empty((na + nr, 3, NL26), dtype=torch.int32, device=device)
    okb = torch.empty(-(-(na + nr) // DECOMPRESS_BLOCK), dtype=torch.uint8,
                      device=device)
    buckets = torch.empty((nb, 4, NL26), dtype=torch.int32, device=device)
    runs = torch.empty((wa * ka + wr * kr, 2, 4, NL26), dtype=torch.int32,
                       device=device)
    groups = torch.empty(((wa * ka + wr * kr) // f, 2, 4, NL26),
                         dtype=torch.int32, device=device)
    sums = torch.empty((wa + wr + 2, 4, NL26), dtype=torch.int32,
                       device=device)
    out = torch.empty(1, dtype=torch.uint8, device=device)
    ptrs = [t.data_ptr() for t in (y_a, sign_a, *plan_a, y_r, sign_r,
                                   *plan_r, b_bytes,
                                   cuda_verify._consts(device),
                                   cuda_verify._base_table8_26(device),
                                   pts, okb, buckets, runs, groups, sums,
                                   out)]
    ints = [na, c_a, wa, nr, c_r, wr, s, f]
    args = ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for i in range(len(STAGES)):
            if stage_events is not None:
                stage_events[i].record(stream)
            err = stage(*args, i, stream.cuda_stream)
            if err != 0:
                break
        if stage_events is not None:
            stage_events[len(STAGES)].record(stream)
    if err != 0:
        raise RuntimeError(f"rlc: CUDA launch failed with cudaError {err}")
    return sums, out
