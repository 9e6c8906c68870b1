"""Wrappers of the hand-written CUDA verify kernels (csrc/*.cu).

The counterpart of cometbft_tpu/ops/pallas_verify.py, with the same
array contract at the wrappers (lane-minor ``(20, N)`` limbs, ``(64, N)``
nibbles, ``(16, 4, 20, N)`` tables):

* ``verify_kernel``        -> K1 ``k1_verify`` (csrc/verify_uncached.cu)
* ``verify_kernel_cached`` -> K2 ``k2_verify_cached`` (csrc/verify_cached.cu)
* ``build_pubkey_tables``  -> X1 ``x1_build_tables`` (csrc/build_tables.cu)
* ``verify_kernel8``       -> K3 ``k3_verify8`` (csrc/verify8_uncached.cu)
* ``verify_kernel8_cached`` -> K4 ``k4_verify8_cached`` (csrc/verify8_cached.cu)

K3 and K4 are the 8-bit flavor: S arrives as ``(32, N)`` little-endian
bytes and [S]B comes from the constant ``(32, 256, 3, 20)`` table of
ops.curve.base_table8, which both kernels read paired to 26-bit limbs
(:func:`_base_table8_26`, built once per device at first use and kept).

K1-K4 run on the 26-bit radix of csrc/fe26.cuh, four threads a lane, and
K1 and K3 keep A's table in shared memory, so no wrapper allocates
scratch. X1 decompresses on fe26.cuh, one thread a lane, and builds the
table four threads a lane on the reference's 13-bit limbs
(csrc/ed25519.cuh), op for op, since it writes the reference's arena. All
five take the 13-bit arrays above.

A CPU tensor goes to the plain PyTorch version in ops/curve.py. A CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback. Every input is checked for device, dtype, shape and contiguity,
outputs are allocated here with ``torch.empty``, ``LAUNCHES`` counts
each kernel's launches (and nothing else) and ``LAUNCH_LANES`` counts
them by the lane count they ran at.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from functools import lru_cache

import torch

from . import build, curve
from .field import NLIMB

TSIZE = curve.TSIZE
WINDOWS = curve.WINDOWS
WINDOWS8 = curve.WINDOWS8

LAUNCHES = {"verify_kernel": 0, "verify_kernel_cached": 0,
            "build_pubkey_tables": 0, "verify_kernel8": 0,
            "verify_kernel8_cached": 0}
SOURCES = {"verify_kernel": "verify_uncached.cu",
           "verify_kernel_cached": "verify_cached.cu",
           "build_pubkey_tables": "build_tables.cu",
           "verify_kernel8": "verify8_uncached.cu",
           "verify_kernel8_cached": "verify8_cached.cu"}

# (field multiplications, field squarings) per lane, counted from the
# reference's formulas (ops/curve.py): a decompression is 19 and 255 (251 squarings in the
# sqrt chain; the sqrt(-1) fix-up multiply that about half the lanes take
# is left out), the ladder 2,004 and 1,036 (64 windows of four doublings
# at 4 + 4, a Niels add at 8 and an affine add at 7; then -R and three
# doublings), a table build 111 and 4. The 8-bit ladder is 1,789 and
# 1,036: the same 64 windows of four doublings and one Niels add (the B
# add leaves the window), 32 affine adds of the fixed-base sum, one
# complete add at 9, then -R and three doublings. The kernels do the same
# field operations.
_DECOMPRESS, _LADDER, _TABLE = (19, 255), (2004, 1036), (111, 4)
_LADDER8 = (64 * (4 * 4 + 8) + 32 * 7 + 9 + 8 + 3 * 4, 64 * 4 * 4 + 3 * 4)
# Each operation is priced at the fewest 32-bit multiply-adds a 255-bit
# product takes, whatever the kernel's limbs: a schoolbook in 8 x 32-bit
# limbs, 64 products of a low and a high half (128) a multiplication and
# 36 (72) a squaring; reductions and carries are not counted. So no radix
# can beat the count, and the rows of every kernel stay comparable.
# Multiply-adds and bytes per lane feed chip_smoke's bound.
MULADDS_PER_MUL, MULADDS_PER_SQ = 2 * 8 * 8, 2 * 8 * 9 // 2


def _muladds(*parts) -> int:
    return sum(MULADDS_PER_MUL * m + MULADDS_PER_SQ * s for m, s in parts)


MULADDS_PER_LANE = {
    "verify_kernel": _muladds(_DECOMPRESS, _DECOMPRESS, _TABLE, _LADDER),
    "verify_kernel_cached": _muladds(_DECOMPRESS, _LADDER),
    "build_pubkey_tables": _muladds(_DECOMPRESS, _TABLE),
    "verify_kernel8": _muladds(_DECOMPRESS, _DECOMPRESS, _TABLE, _LADDER8),
    "verify_kernel8_cached": _muladds(_DECOMPRESS, _LADDER8),
}
# bytes each lane must move: inputs read once, outputs written once
BYTES_PER_LANE = {
    # y_a, sign_a, y_r, sign_r, s_nibs, kneg_nibs (int32), verdict (1 B)
    "verify_kernel": 4 * (2 * NLIMB + 2 + 2 * WINDOWS) + 1,
    # + A's table rows (16*4*20 int32), its ok byte, a uint16 slot
    "verify_kernel_cached": 4 * (NLIMB + 1 + 2 * WINDOWS)
    + 4 * TSIZE * 4 * NLIMB + 1 + 2 + 1,
    # y_a, sign_a in; table and ok byte out
    "build_pubkey_tables": 4 * (NLIMB + 1) + 4 * TSIZE * 4 * NLIMB + 1,
    # K1's with s_bytes (32 int32) for s_nibs
    "verify_kernel8": 4 * (2 * NLIMB + 2 + WINDOWS8 + WINDOWS) + 1,
    "verify_kernel8_cached": 4 * (NLIMB + 1 + WINDOWS8 + WINDOWS)
    + 4 * TSIZE * 4 * NLIMB + 1 + 2 + 1,
}
# K3/K4 also read the entries of the fixed-base table that their S bytes
# name, once per launch: 120 B each (30 int32) from the paired copy.
TABLE8_ENTRY_BYTES = {"verify_kernel8": 4 * 3 * NLIMB // 2,
                      "verify_kernel8_cached": 4 * 3 * NLIMB // 2}


# each kernel's launches since the last reset, by lane count
LAUNCH_LANES: dict[str, collections.Counter] = {
    k: collections.Counter() for k in LAUNCHES}


# Launches on the card of the device programs that the port runs as torch
# ops (ops/verify.py), counted as the kernels' are: X2, the arena scatter
# (PubkeyTableCache._scatter), and X3, the wire unpack (unpack_on_device,
# _unpack_rsk_on_device) and the verdict bit-pack (_pack_ok_bits). A CPU
# tensor counts none.
OP_LAUNCHES = {"x2_scatter": 0, "x3_unpack": 0, "x3_bitpack": 0}


def count_op(name: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        OP_LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_LANES[k].clear()
    for k in OP_LAUNCHES:
        OP_LAUNCHES[k] = 0


def _check(name, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _cuda_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: cpu or cuda only")


# The kernels read their constants by pointer after the wrapper returns, so
# each device's copy is made once, under a lock, and kept. (A copy made by
# a racing first call and then dropped would free memory that another
# thread's next tensor on the same stream may take and overwrite before
# the queued kernel reads it.)
_CONST_LOCK = threading.Lock()
_CONSTS: dict = {}


def _kept(kind: str, device: torch.device, make) -> torch.Tensor:
    with _CONST_LOCK:
        t = _CONSTS.get((kind, device))
        if t is None:
            t = _CONSTS[(kind, device)] = make(device)
        return t


def _consts(device: torch.device) -> torch.Tensor:
    """The field constants (ops.curve.kernel_consts) on ``device``."""
    return _kept("consts", device,
                 lambda d: torch.from_numpy(curve.kernel_consts()).to(d))


def _base_table8_26(device: torch.device) -> torch.Tensor:
    return _kept("base_table8_26", device, _make_base_table8_26)


def _make_base_table8_26(device: torch.device) -> torch.Tensor:
    """K3's and K4's fixed-base table: ops.curve.base_table8 with each pair
    of 13-bit limbs joined into one 26-bit limb, ``l[2i] + (l[2i+1] <<
    13)``, as (32, 256, 32) int32: (y+x, y-x, 2dxy) in words 0-29 of an
    entry, two words of zeros, 128 B an entry (1,048,576 B in all). Built
    once per device at first use and kept."""
    t = curve.base_table8(device)
    paired = t[..., 0::2] + (t[..., 1::2] << 13)
    out = torch.zeros((WINDOWS8, 256, 32), dtype=torch.int32, device=device)
    out[..., : 3 * NLIMB // 2] = paired.reshape(WINDOWS8, 256, -1)
    return out


_PTR = ctypes.c_void_p


@lru_cache(maxsize=None)
def _entries():
    """The C entry of each kernel, from the built libraries."""
    libs = {k: build.load_all()[v[:-3]] for k, v in SOURCES.items()}
    k1 = libs["verify_kernel"].ed25519_verify
    k1.argtypes = [_PTR] * 8 + [ctypes.c_int, _PTR]
    k2 = libs["verify_kernel_cached"].ed25519_verify_cached
    k2.argtypes = [_PTR] * 3 + [ctypes.c_int] + [_PTR] * 6 + [ctypes.c_int, _PTR]
    x1 = libs["build_pubkey_tables"].ed25519_build_tables
    x1.argtypes = [_PTR] * 5 + [ctypes.c_int, _PTR]
    k3 = libs["verify_kernel8"].ed25519_verify8
    k3.argtypes = [_PTR] * 9 + [ctypes.c_int, _PTR]
    k4 = libs["verify_kernel8_cached"].ed25519_verify8_cached
    k4.argtypes = [_PTR] * 3 + [ctypes.c_int] + [_PTR] * 7 + [ctypes.c_int,
                                                              _PTR]
    for fn in (k1, k2, x1, k3, k4):
        fn.restype = ctypes.c_int
    return {"verify_kernel": k1, "verify_kernel_cached": k2,
            "build_pubkey_tables": x1, "verify_kernel8": k3,
            "verify_kernel8_cached": k4}


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call one kernel's C entry on the current stream; raise on a launch
    error. Every entry's last argument before the stream is its lane
    count."""
    fn = _entries()[kernel]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
    LAUNCHES[kernel] += 1
    LAUNCH_LANES[kernel][args[-1]] += 1


def _p(t: torch.Tensor):
    return t.data_ptr()


def _check_rsk(y_r, sign_r, s, kneg_nibs, n, device, s_name="s_nibs",
               s_rows=WINDOWS) -> None:
    _check("y_r", y_r, torch.int32, (NLIMB, n), device)
    _check("sign_r", sign_r, torch.int32, (n,), device)
    _check(s_name, s, torch.int32, (s_rows, n), device)
    _check("kneg_nibs", kneg_nibs, torch.int32, (WINDOWS, n), device)


def _arena_check(arena, arena_ok, idxs, n, device) -> int:
    slots = arena.shape[-1]
    _check("arena", arena, torch.int32, (TSIZE, 4, NLIMB, slots), device)
    _check("arena_ok", arena_ok, torch.bool, (slots,), device)
    _check("idxs", idxs, torch.int16, (n,), device)
    return slots


def verify_kernel(y_a, sign_a, y_r, sign_r, s_nibs, kneg_nibs):
    """K1: (N,) bool, [8]([S]B + [-k]A - R) == O and A, R decoded.

    Same contract as ops.curve.verify_kernel (pallas_verify.verify_kernel):
    y_a, y_r (20, N) int32; sign_a, sign_r (N,) int32; s_nibs, kneg_nibs
    (64, N) int32 MSB-first 4-bit windows.
    """
    device = y_a.device
    n = y_a.shape[-1]
    _check("y_a", y_a, torch.int32, (NLIMB, n), device)
    _check("sign_a", sign_a, torch.int32, (n,), device)
    _check_rsk(y_r, sign_r, s_nibs, kneg_nibs, n, device)
    if device.type == "cpu":
        return curve.verify_kernel(y_a, sign_a, y_r, sign_r, s_nibs, kneg_nibs)
    _cuda_device(device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    _launch(
        "verify_kernel", device,
        _p(y_a), _p(sign_a), _p(y_r), _p(sign_r), _p(s_nibs), _p(kneg_nibs),
        _p(_consts(device)), _p(out), n,
    )
    return out


def verify_kernel_cached(arena, arena_ok, y_r, sign_r, s_nibs, kneg_nibs, *,
                         idxs):
    """K2: the ladder with a pre-expanded pubkey table, ANDed with its ok
    bit.

    ``arena`` is a (16, 4, 20, S) int32 pubkey arena and ``arena_ok`` its
    (S,) ok bits; ``idxs`` (N,) int16 holds uint16 slot numbers, and lane i
    reads slot idxs[i] in place: no gathered copy. A slot >= S verifies
    False. The plain version is ops.curve.verify_kernel_slots.
    """
    device = y_r.device
    n = y_r.shape[-1]
    _check_rsk(y_r, sign_r, s_nibs, kneg_nibs, n, device)
    slots = _arena_check(arena, arena_ok, idxs, n, device)
    if device.type == "cpu":
        return curve.verify_kernel_slots(arena, arena_ok, idxs, y_r, sign_r,
                                         s_nibs, kneg_nibs)
    _cuda_device(device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    _launch(
        "verify_kernel_cached", device,
        _p(arena), _p(arena_ok), _p(idxs), slots,
        _p(y_r), _p(sign_r), _p(s_nibs), _p(kneg_nibs), _p(_consts(device)),
        _p(out), n,
    )
    return out


def build_pubkey_tables(y_a, sign_a):
    """X1: (table (16, 4, 20, M) int32, ok (M,) bool) for M pubkeys,
    the contract of ops.curve.build_pubkey_tables."""
    device = y_a.device
    m = y_a.shape[-1]
    _check("y_a", y_a, torch.int32, (NLIMB, m), device)
    _check("sign_a", sign_a, torch.int32, (m,), device)
    if device.type == "cpu":
        return curve.build_pubkey_tables(y_a, sign_a)
    _cuda_device(device)
    table = torch.empty((TSIZE, 4, NLIMB, m), dtype=torch.int32,
                        device=device)
    ok = torch.empty(m, dtype=torch.bool, device=device)
    if m == 0:
        return table, ok
    _launch(
        "build_pubkey_tables", device,
        _p(y_a), _p(sign_a), _p(_consts(device)), _p(table), _p(ok), m,
    )
    return table, ok


def verify_kernel8(y_a, sign_a, y_r, sign_r, s_bytes, kneg_nibs):
    """K3: :func:`verify_kernel` with [S]B on 8-bit fixed-base windows.

    The contract of ops.curve.verify_kernel8 (pallas_verify.verify_kernel8):
    ``s_bytes`` (32, N) int32 holds S's little-endian bytes, byte j the
    window of weight 2^(8j); ``kneg_nibs`` stays (64, N) MSB-first 4-bit
    windows.
    """
    device = y_a.device
    n = y_a.shape[-1]
    _check("y_a", y_a, torch.int32, (NLIMB, n), device)
    _check("sign_a", sign_a, torch.int32, (n,), device)
    _check_rsk(y_r, sign_r, s_bytes, kneg_nibs, n, device, "s_bytes",
               WINDOWS8)
    if device.type == "cpu":
        return curve.verify_kernel8(y_a, sign_a, y_r, sign_r, s_bytes,
                                    kneg_nibs)
    _cuda_device(device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    _launch(
        "verify_kernel8", device,
        _p(y_a), _p(sign_a), _p(y_r), _p(sign_r), _p(s_bytes),
        _p(kneg_nibs), _p(_consts(device)), _p(_base_table8_26(device)),
        _p(out), n,
    )
    return out


def verify_kernel8_cached(arena, arena_ok, y_r, sign_r, s_bytes, kneg_nibs,
                          *, idxs):
    """K4: :func:`verify_kernel_cached`'s arena-and-slot contract with the
    8-bit [S]B of :func:`verify_kernel8`. Lane i reads slot idxs[i] of the
    (16, 4, 20, S) arena in place; a slot >= S verifies False. The plain
    version is ops.curve.verify_kernel8_slots.
    """
    device = y_r.device
    n = y_r.shape[-1]
    _check_rsk(y_r, sign_r, s_bytes, kneg_nibs, n, device, "s_bytes",
               WINDOWS8)
    slots = _arena_check(arena, arena_ok, idxs, n, device)
    if device.type == "cpu":
        return curve.verify_kernel8_slots(arena, arena_ok, idxs, y_r, sign_r,
                                          s_bytes, kneg_nibs)
    _cuda_device(device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    _launch(
        "verify_kernel8_cached", device,
        _p(arena), _p(arena_ok), _p(idxs), slots,
        _p(y_r), _p(sign_r), _p(s_bytes), _p(kneg_nibs), _p(_consts(device)),
        _p(_base_table8_26(device)), _p(out), n,
    )
    return out
