"""Batched GF(2^255 - 19) field arithmetic in PyTorch (int32 limbs).

The plain tensor version of the field code of the arena builder X1's
table (csrc/ed25519.cuh), with the same representation so that limbs
compare one for one (the verify kernels pair these limbs into the 26-bit ones of
csrc/fe26.cuh on load):

* A field element is ``(20, *batch)`` int32 limbs of 13 bits each,
  little-endian along axis 0 (value = sum(limb[i] << (13*i))), batch
  axes last so the signature axis is minor-most.
* Lazy reduction with one closed invariant: every op takes limbs
  <= 10015 and returns limbs <= 10015. add/sub/neg/dbl2 need one carry
  pass and the mul column fold three. A schoolbook column holds at most
  20 products of <= 10015^2, so it stays below 2^31 and every
  intermediate fits int32. Values are canonical (< p) only after
  :func:`canonical`.
* ``>>`` on int32 tensors is an arithmetic shift, which the borrow chain
  of :func:`canonical` relies on.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

BITS = 13
NLIMB = 20
MASK = (1 << BITS) - 1
P = 2**255 - 19

# 2^(13*20) = 2^260 == 19 * 2^5 (mod p): fold factor for limb index 20.
FOLD = 19 << 5  # 608

# Subtraction bias: == 0 mod p, every limb >= 8191 so (bias + a - b) has
# non-negative limbs for any lazily-reduced a, b. Built from 2*(2^260 - 1)
# (all limbs 16382) with the residue 1214 = 2*(608 - 1) removed from limb 0.
_SUB_BIAS = (16382 - 1214,) + (16382,) * (NLIMB - 1)
assert (sum(l << (BITS * i) for i, l in enumerate(_SUB_BIAS)) % P) == 0

# p in canonical 13-bit limbs: [8173, 8191 x 18, 255].
_P_LIMBS = tuple((P >> (BITS * i)) & MASK for i in range(NLIMB))


def to_limbs(x: int) -> np.ndarray:
    """Python int -> (20,) limb vector (host helper)."""
    return np.array([(x >> (BITS * i)) & MASK for i in range(NLIMB)], np.int32)


def from_limbs(limbs) -> int:
    """(20,) limb vector -> Python int (host helper; accepts lazy limbs)."""
    limbs = np.asarray(limbs)
    return sum(int(l) << (BITS * i) for i, l in enumerate(limbs))


@lru_cache(maxsize=None)
def _limb_const(limbs: tuple, device: torch.device, batch_ndim: int):
    # built once per device: a fresh host->device copy on every field op
    # would wait for the stream each time
    return torch.tensor(limbs, dtype=torch.int32, device=device).reshape(
        (NLIMB,) + (1,) * batch_ndim
    )


def const(x: int, ref: torch.Tensor) -> torch.Tensor:
    """Constant field element shaped to broadcast against ``ref``."""
    return _limb_const(
        tuple(int(v) for v in to_limbs(x)), ref.device, ref.dim() - 1
    )


def _limb_vector(limbs, ref: torch.Tensor) -> torch.Tensor:
    return _limb_const(tuple(limbs), ref.device, ref.dim() - 1)


def carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry propagation with mod-p folding (axis 0 = limbs).

    Each pass splits every limb into its low 13 bits plus a carry, moves
    the carries up one limb, and folds the carry out of limb 19 (weight
    2^260) back into limb 0 with factor 608.
    """
    for _ in range(passes):
        lo = x & MASK
        hi = x >> BITS
        rolled = torch.roll(hi, 1, dims=0)
        x = lo + torch.cat([rolled[:1] * FOLD, rolled[1:]], dim=0)
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, passes=1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + _limb_vector(_SUB_BIAS, a) - b, passes=1)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(_limb_vector(_SUB_BIAS, a) - a, passes=1)


def dbl2(a: torch.Tensor) -> torch.Tensor:
    return carry(a + a, passes=1)


def _fold_cols(cols: torch.Tensor) -> torch.Tensor:
    """Reduce 39 product columns to 20 lazy limbs.

    High columns are split into lo13/hi parts before the fold factor
    multiplies them, so every intermediate stays inside int32; three
    carry passes restore the <= 10015 invariant.
    """
    lo_cols = cols[:NLIMB]
    hi_cols = cols[NLIMB:]  # 19 columns, weight 2^(260 + 13*i)
    zero = torch.zeros_like(hi_cols[:1])
    hi_lo = torch.cat([(hi_cols & MASK) * FOLD, zero], dim=0)
    hi_hi = torch.cat([zero, (hi_cols >> BITS) * FOLD], dim=0)
    return carry(lo_cols + hi_lo + hi_hi, passes=3)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched field multiplication.

    Schoolbook outer product over the leading limb axes, then a shear:
    pad rows to width 40, flatten the two leading axes, drop the tail and
    reshape to (20, 39, *batch), so element (i, j) lands in column i + j
    and an axis-0 sum gives the 39 anti-diagonal columns.
    """
    a, b = torch.broadcast_tensors(a, b)
    prod = a[:, None] * b[None, :]  # (20, 20, *batch)
    batch = prod.shape[2:]
    padded = torch.cat([prod, torch.zeros_like(prod)], dim=1)
    sheared = padded.reshape((NLIMB * 2 * NLIMB,) + batch)[
        : NLIMB * (2 * NLIMB - 1)
    ].reshape((NLIMB, 2 * NLIMB - 1) + batch)
    # torch.sum promotes int32 to int64 unless told otherwise
    cols = torch.sum(sheared, dim=0, dtype=torch.int32)
    return _fold_cols(cols)


def sq(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the unique representative in [0, p).

    Sequential carries, 2^255 -> 19 folding, then one conditional
    subtract of p. Inputs must satisfy the lazy bound (limbs <= 10015),
    for which two ripple rounds reach a fixpoint.
    """
    for _ in range(2):
        limbs = []
        c = torch.zeros_like(x[0])
        for i in range(NLIMB - 1):
            v = x[i] + c
            limbs.append(v & MASK)
            c = v >> BITS
        v = x[NLIMB - 1] + c
        limbs.append(v & 0xFF)
        top = v >> 8  # weight 2^255 == 19
        limbs[0] = limbs[0] + top * 19
        x = torch.stack(limbs, dim=0)
    borrow = torch.zeros_like(x[0])
    diff = []
    for i in range(NLIMB):
        v = x[i] - _P_LIMBS[i] + borrow
        diff.append(v & (MASK if i < NLIMB - 1 else 0xFF))
        borrow = v >> (BITS if i < NLIMB - 1 else 8)  # arithmetic: 0 or -1
    ge_p = borrow == 0
    return torch.where(ge_p[None], torch.stack(diff, dim=0), x)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """True where x == 0 mod p. Shape (*batch,)."""
    return torch.all(canonical(x) == 0, dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == canonical(b), dim=0)


def _sq_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sq(x)
    return x


def pow_2_252_m3(z: torch.Tensor) -> torch.Tensor:
    """z ** (2^252 - 3), the ed25519 decompression square-root exponent,
    by the curve25519 addition chain (~254 squarings + 11 multiplies)."""
    z2 = sq(z)  # 2
    z8 = _sq_n(z2, 2)  # 8
    z9 = mul(z, z8)  # 9
    z11 = mul(z2, z9)  # 11
    z22 = sq(z11)  # 22
    z_5_0 = mul(z9, z22)  # 2^5 - 2^0
    z_10_0 = mul(_sq_n(z_5_0, 5), z_5_0)  # 2^10 - 2^0
    z_20_0 = mul(_sq_n(z_10_0, 10), z_10_0)  # 2^20 - 2^0
    z_40_0 = mul(_sq_n(z_20_0, 20), z_20_0)  # 2^40 - 2^0
    z_50_0 = mul(_sq_n(z_40_0, 10), z_10_0)  # 2^50 - 2^0
    z_100_0 = mul(_sq_n(z_50_0, 50), z_50_0)  # 2^100 - 2^0
    z_200_0 = mul(_sq_n(z_100_0, 100), z_100_0)  # 2^200 - 2^0
    z_250_0 = mul(_sq_n(z_200_0, 50), z_50_0)  # 2^250 - 2^0
    return mul(_sq_n(z_250_0, 2), z)  # 2^252 - 3
