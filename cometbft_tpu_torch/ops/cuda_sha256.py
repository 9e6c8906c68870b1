"""Wrapper of X4, the hand-written SHA-256 kernel (csrc/sha256.cu).

The counterpart of cometbft_tpu/ops/sha256.py ``_sha256_kernel``, with its
array contract: ``(B, 16, L)`` uint32 big-endian words, lane last, and
``(L,)`` block counts (uint16, or int32 when B > 65,535) in; the ``(8, L)``
uint32 state out. Lanes past their count, the padding lanes included,
keep the initial state; a count above B is read as B, as the reference's
scan over B blocks reads it.

A CPU tensor goes to the plain PyTorch version (ops.sha256.sha256_plain).
A CUDA tensor launches the kernel on the current stream or raises: there
is no fallback. Inputs are checked for dtype, shape, device and
contiguity, the output is allocated here with ``torch.empty``,
``LAUNCHES`` counts the kernel's launches (and nothing else) and
``LAUNCH_SHAPES`` counts them by (block bucket, lane bucket).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import torch

from . import build

LAUNCHES = {"sha256": 0}
LAUNCH_SHAPES: dict[str, dict[tuple[int, int], int]] = {"sha256": {}}
SOURCES = {"sha256": "sha256.cu"}
# bytes the device path copied in and out (sha256_many_async), since the
# last reset
TRANSFERS = {"h2d_bytes": 0, "d2h_bytes": 0}
_counts_lock = threading.Lock()

# The fewest 32-bit integer instructions one compression takes on compute
# capability 9.0, where a rotation is one funnel shift, any function of
# three words one LOP3 and a sum of three words one IADD3: 48 schedule
# words of 10 (sigma0 and sigma1 at 4: two rotations, a shift, a LOP3;
# the four-term sum in 2 IADD3), 64 rounds of 14 (Sigma1 and Sigma0 at 4:
# three rotations and a LOP3; Ch and Maj one LOP3 each; T1's five terms
# in 2 IADD3, e = d + T1 one, a = T1 + Sigma0 + Maj one), and the 8
# additions into the state: 1,384. The shifts and LOP3s (1,024) issue
# only on the integer pipe; the additions could also go to the FMA pipe
# as IMADs, so the bound prices both (chip_smoke.x4_bound).
SHIFT_LOGIC_PER_BLOCK = 48 * 8 + 64 * 10
OPS_PER_BLOCK = SHIFT_LOGIC_PER_BLOCK + 48 * 2 + 64 * 4 + 8
# bytes the bound counts: each real block read once, each lane's block
# count read once and its state written once
BYTES_PER_BLOCK = 64
STATE_BYTES_PER_LANE = 32


def reset_launches() -> None:
    with _counts_lock:
        LAUNCHES["sha256"] = 0
        LAUNCH_SHAPES["sha256"].clear()
        TRANSFERS.update(h2d_bytes=0, d2h_bytes=0)


def note_transfer(h2d: int, d2h: int) -> None:
    with _counts_lock:
        TRANSFERS["h2d_bytes"] += h2d
        TRANSFERS["d2h_bytes"] += d2h


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """The values of an integer tensor as int64; uint16 and uint32 go
    through a signed view of the same width, so no unsigned kernel runs."""
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}.get(
        t.dtype)
    if signed is None:
        return t.to(torch.int64)
    return t.view(signed).to(torch.int64) & ((1 << 8 * t.element_size()) - 1)


def work(nblocks: torch.Tensor, bucket: int) -> tuple[int, int, int]:
    """(integer instructions, the shifts and LOP3s among them, bytes) a
    launch on these block counts, at block bucket ``bucket``, must do: the
    real blocks only."""
    real = int(as_int64(nblocks).clamp(max=bucket).sum())
    lanes = nblocks.numel()
    return (OPS_PER_BLOCK * real, SHIFT_LOGIC_PER_BLOCK * real,
            BYTES_PER_BLOCK * real
            + lanes * (nblocks.element_size() + STATE_BYTES_PER_LANE))


@lru_cache(maxsize=None)
def _entry():
    fn = build.load_all([SOURCES["sha256"]])["sha256"].sha256_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build (at first use) and load X4."""
    _entry()


def sha256(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """X4: ``(8, L)`` uint32 SHA-256 state of each lane of the wire."""
    if not isinstance(blocks, torch.Tensor) or not isinstance(
            nblocks, torch.Tensor):
        raise TypeError("blocks and nblocks must be tensors")
    if blocks.dtype != torch.uint32:
        raise TypeError(f"blocks: dtype {blocks.dtype}, expected uint32")
    if blocks.dim() != 3 or blocks.shape[1] != 16:
        raise ValueError(f"blocks: shape {tuple(blocks.shape)}, expected "
                         "(B, 16, L)")
    bb, _, lanes = blocks.shape
    want = torch.uint16 if bb <= 0xFFFF else torch.int32
    if nblocks.dtype != want:
        raise TypeError(f"nblocks: dtype {nblocks.dtype}, expected {want} "
                        f"at block bucket {bb}")
    if tuple(nblocks.shape) != (lanes,):
        raise ValueError(f"nblocks: shape {tuple(nblocks.shape)}, expected "
                         f"({lanes},)")
    if nblocks.device != blocks.device:
        raise ValueError(f"nblocks: on {nblocks.device}, expected "
                         f"{blocks.device}")
    if not (blocks.is_contiguous() and nblocks.is_contiguous()):
        raise ValueError("blocks and nblocks must be contiguous")
    device = blocks.device
    if device.type == "cpu":
        from .sha256 import sha256_plain

        return sha256_plain(blocks, nblocks)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: cpu or cuda only")
    state = torch.empty((8, lanes), dtype=torch.uint32, device=device)
    if lanes == 0:
        return state
    fn = _entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(blocks.data_ptr(), nblocks.data_ptr(),
                 int(want == torch.uint16), state.data_ptr(), bb, lanes,
                 stream)
    if err != 0:
        raise RuntimeError(f"sha256: CUDA launch failed with cudaError {err}")
    with _counts_lock:
        LAUNCHES["sha256"] += 1
        shapes = LAUNCH_SHAPES["sha256"]
        shapes[(bb, lanes)] = shapes.get((bb, lanes), 0) + 1
    return state
