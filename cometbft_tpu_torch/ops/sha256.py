"""Batched SHA-256: the hash half of the device plane (X4).

Port of cometbft_tpu/ops/sha256.py. The callers (PartSet leaves and
proofs, merkle levels, tx keys) reach it through crypto/hashplane.py.

Split of labor:

* Host (numpy): SHA-256 padding (0x80, zero fill, 64-bit big-endian bit
  length) and big-endian word extraction into bucketed arrays, byte for
  byte the reference's wire: ``(B, 16, L)`` uint32 blocks, lane last, and
  ``(L,)`` block counts, uint16 while B <= 65,535 and int32 above. B is
  the power-of-two bucket of the longest message's block count, L the
  power-of-two lane bucket (at least 8) of the message count.
* Device: X4, the hand-written kernel of ops/csrc/sha256.cu behind
  ops/cuda_sha256.py, one thread a lane, each lane walking its own block
  count. On the CPU the same wrapper runs :func:`sha256_plain`.

:func:`sha256_many_async` stages the wire through pinned host buffers,
launches on the current stream, copies the state back into a pinned
buffer and records an event; its materializer waits on that event only.
Entry points take ``device=`` and default to ``"cuda"``; without a GPU
they raise. Digests are bit-identical to ``hashlib.sha256``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import cuda_sha256
from .verify import resolve_device

_MIN_LANES = 8
# Lanes per launch; the hash plane's windows stay below it.
MAX_LANES = 8192

# Round constants and initial state (FIPS 180-4); csrc/sha256.cu holds the
# same values.
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)


# -- host-side pack ---------------------------------------------------------


def n_blocks(msg_len: int) -> int:
    """Padded 64-byte block count of an ``msg_len``-byte message."""
    return (msg_len + 8) // 64 + 1


def block_bucket(blocks: int) -> int:
    """Smallest power of two holding ``blocks`` (>= 1)."""
    b = 1
    while b < blocks:
        b *= 2
    return b


def lane_bucket(n: int) -> int:
    """Smallest power-of-two lane bucket holding n (8 <= bucket)."""
    b = _MIN_LANES
    while b < n:
        b *= 2
    return b


def _pad(msg: bytes) -> bytes:
    """FIPS 180-4 padding: 0x80, zeros, 64-bit big-endian bit length."""
    ln = len(msg)
    rem = (ln + 1 + 8) % 64
    zeros = (64 - rem) % 64
    return msg + b"\x80" + b"\x00" * zeros + (8 * ln).to_bytes(8, "big")


_TORCH_NB = {np.uint16: torch.uint16, np.int32: torch.int32}


def _wire_shape(msgs, blocks_cap):
    """(block counts, block bucket, lane bucket, nblocks dtype)."""
    nb = [n_blocks(len(m)) for m in msgs]
    bb = blocks_cap if blocks_cap is not None else block_bucket(max(nb, default=1))
    # the narrowest type that holds the bucket's block count
    return nb, bb, lane_bucket(len(msgs)), (np.uint16 if bb <= 0xFFFF
                                            else np.int32)


def _fill(msgs, nb, blocks: np.ndarray, nblocks: np.ndarray) -> None:
    """Write the padded messages into zeroed wire arrays."""
    bb = blocks.shape[0]
    for i, m in enumerate(msgs):
        k = nb[i]
        if k > bb:
            raise ValueError(f"message of {k} blocks exceeds bucket {bb}")
        blocks[:k, :, i] = np.frombuffer(_pad(bytes(m)), ">u4").reshape(k, 16)
        nblocks[i] = k


def pack_messages(msgs, blocks_cap: int | None = None):
    """Pack a message list into one bucketed wire buffer.

    Returns ``(blocks (B, 16, L) uint32, nblocks (L,))`` as numpy arrays,
    the reference's arrays and dtypes exactly. Callers group messages by
    block bucket first (the hash plane's window split); ``blocks_cap``
    sets B (None computes it here) and a longer message raises.
    """
    nb, bb, lb, nb_dtype = _wire_shape(msgs, blocks_cap)
    blocks = np.zeros((bb, 16, lb), np.uint32)
    nblocks = np.zeros(lb, nb_dtype)
    _fill(msgs, nb, blocks, nblocks)
    return blocks, nblocks


def _digests_from_state(arr: np.ndarray, n: int) -> list[bytes]:
    """(8, L) uint32 host state -> n 32-byte big-endian digests."""
    raw = np.ascontiguousarray(arr.T[:n]).astype(">u4").tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(n)]


# -- the plain version of X4 ------------------------------------------------

_M32 = 0xFFFFFFFF
# rotate amounts of the four sigma functions (FIPS 180-4, 4.4-4.7); the
# small ones also shift right by the third amount
_BIG0, _BIG1 = (2, 13, 22), (6, 11, 25)
_SMALL0, _SMALL1 = (7, 18, 3), (17, 19, 10)


def _rot_consts(device) -> dict:
    def col(v):
        return torch.tensor(v, dtype=torch.int64, device=device)[:, None]

    return {name: (col(r), col([32 - x for x in r]))
            for name, r in (("big0", _BIG0), ("big1", _BIG1),
                            ("small0", _SMALL0[:2]), ("small1", _SMALL1[:2]))}


def _rotr_xor(x, rot):
    """XOR of x rotated right by each amount of ``rot`` (uint32 values
    held in int64)."""
    right, left = rot
    r = ((x >> right) | (x << left)) & _M32
    out = r[0]
    for i in range(1, r.shape[0]):
        out = out ^ r[i]
    return out


def _compress_plain(state, words, k, rots):
    """One compression on int64 lanes: state (8, L), words (16, L)."""
    w = list(words)
    for t in range(16, 64):
        s0 = _rotr_xor(w[t - 15], rots["small0"]) ^ (w[t - 15] >> _SMALL0[2])
        s1 = _rotr_xor(w[t - 2], rots["small1"]) ^ (w[t - 2] >> _SMALL1[2])
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    kw = k + torch.stack(w)  # (64, L): K[t] + W[t], at most 33 bits
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _rotr_xor(e, rots["big1"]) + (g ^ (e & (f ^ g))) + kw[t]
        t2 = _rotr_xor(a, rots["big0"]) + ((a & b) | (c & (a | b)))
        h, g, f = g, f, e
        e = (d + t1) & _M32
        d, c, b = c, b, a
        a = (t1 + t2) & _M32
    return (state + torch.stack([a, b, c, d, e, f, g, h])) & _M32


def sha256_plain(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of X4: ``(B, 16, L)`` uint32 blocks and
    ``(L,)`` block counts -> ``(8, L)`` uint32 state, on the inputs' device.

    Vectorised over lanes on int64 tensors masked to 32 bits (uint32 has
    no shifts here). It runs only to the longest lane's real block count,
    not to B; a lane whose message has ended keeps its state, so lanes
    with no blocks hold the initial state, and a count above B is read as
    B, as in the reference.
    """
    dev = blocks.device
    lanes = blocks.shape[2]
    nb = cuda_sha256.as_int64(nblocks).clamp(max=blocks.shape[0])
    state = torch.from_numpy(_H0.astype(np.int64)).to(dev)[:, None]
    state = state.repeat(1, lanes)
    k = torch.from_numpy(_K.astype(np.int64)).to(dev)[:, None]
    rots = _rot_consts(dev)
    for b in range(int(nb.max()) if lanes else 0):
        new = _compress_plain(state, cuda_sha256.as_int64(blocks[b]), k, rots)
        state = torch.where((nb > b)[None, :], new, state)
    return state.to(torch.int32).view(torch.uint32)  # wraps to 32 bits


# -- dispatch ---------------------------------------------------------------


def sha256_many_async(msgs, blocks_cap: int | None = None, device="cuda"):
    """Dispatch one bucketed batch; returns a zero-arg materializer giving
    the per-lane 32-byte digests (bit-identical to ``hashlib.sha256``).

    On a CUDA device the wire is packed into pinned host buffers, copied
    and hashed by X4 on the current stream, and the state copied back into
    a pinned buffer behind a recorded event; the materializer waits on
    that event alone. On the CPU the plain version runs here. Callers keep
    lanes within one block bucket (``blocks_cap``) and under
    :data:`MAX_LANES`.
    """
    n = len(msgs)
    if n == 0:
        return lambda: []
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes exceed the {MAX_LANES}-lane launch cap")
    dev = resolve_device(device)
    if dev.type == "cpu":
        blocks, nblocks = pack_messages(msgs, blocks_cap)
        state = cuda_sha256.sha256(torch.from_numpy(blocks),
                                   torch.from_numpy(nblocks))
        return lambda: _digests_from_state(state.numpy(), n)
    nb, bb, lb, nb_dtype = _wire_shape(msgs, blocks_cap)
    host_blocks = torch.zeros((bb, 16, lb), dtype=torch.uint32,
                              pin_memory=True)
    host_nb = torch.zeros(lb, dtype=_TORCH_NB[nb_dtype], pin_memory=True)
    _fill(msgs, nb, host_blocks.numpy(), host_nb.numpy())
    with torch.cuda.device(dev):
        blocks = host_blocks.to(dev, non_blocking=True)
        nblocks = host_nb.to(dev, non_blocking=True)
        state = cuda_sha256.sha256(blocks, nblocks)
        host_state = torch.empty((8, lb), dtype=torch.uint32, pin_memory=True)
        host_state.copy_(state, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    cuda_sha256.note_transfer(
        h2d=host_blocks.nbytes + host_nb.nbytes, d2h=host_state.nbytes)
    # every buffer stays referenced until the copies behind `done` ran
    keep = [host_blocks, host_nb, blocks, nblocks, state]

    def materialize() -> list[bytes]:
        done.synchronize()
        keep.clear()
        return _digests_from_state(host_state.numpy(), n)

    return materialize


def sha256_many_host(msgs) -> list[bytes]:
    """The host oracle: one ``hashlib`` digest per message."""
    return [hashlib.sha256(m).digest() for m in msgs]
