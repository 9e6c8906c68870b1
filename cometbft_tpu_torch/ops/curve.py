"""Batched edwards25519 point arithmetic and the plain verify functions.

The plain PyTorch versions of the hand-written kernels in csrc/*.cu:
the CPU path of ops/cuda_verify.py, and what the kernels are held
against on the card.

* Points are extended twisted-Edwards coordinates stacked as
  ``(4, 20, *B)`` int32 tensors ([X, Y, Z, T] of 20-limb field elements,
  see ops.field), batch axes last.
* All formulas are the complete a=-1 addition laws, valid for every input
  including identity and small-order points. Completeness is required
  under ZIP-215 (crypto/ed25519/ed25519.go:26-29 in the Go engine): mixed-
  order points are admissible and the cofactored equation
  [8]([S]B - [k]A - R) == O must be evaluated exactly.
* Decompression computes the square-root candidate
  x = u*v^3*(u*v^7)^((p-5)/8) batched; non-points come back as a False
  lane in the validity mask.
* [S]B + [k']A (k' = -k mod L, legal under the cofactored check since
  [8][L]A = O) is a joint 4-bit windowed ladder: 64 windows of four
  doublings, one add from a per-lane 16-entry table of A multiples and one
  add from a constant 16-entry table of B multiples, both kept in Niels
  form (Y+X, Y-X, 2Z, 2dT) so a table add costs 8 field muls (7 when the
  entry is affine).
* The 8-bit flavor (K3/K4, COMETBFT_TPU_KERNEL=pallas8|xla8) keeps the
  4-bit ladder for [k']A alone and takes [S]B from 32 fixed-base windows
  of 8 bits: 32 affine adds of entries [v * 2^(8j)]B from a constant
  (32, 256, 3, 20) table, joined to the ladder by one complete add. On
  the TPU the 256-entry select was a one-hot matmul for the MXU; here it
  is an indexed gather.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import field
from .field import add, canonical, dbl2, eq, is_zero, mul, neg, sq, sub

P = field.P
L = 2**252 + 27742317777372353535851937790883648493
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)
_BY = (4 * pow(5, P - 2, P)) % P

WINDOWS = 64  # 4-bit windows over 256-bit scalars
WBITS = 4
TSIZE = 1 << WBITS
WINDOWS8 = 32  # 8-bit fixed-base windows of S, little-endian bytes
TSIZE8 = 256
NLIMB = field.NLIMB


def _recover_x_int(y: int, sign: int) -> int:
    u = (y * y - 1) % P
    v = (D_INT * y * y + 1) % P
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    if (v * x * x - u) % P != 0:
        x = x * SQRT_M1_INT % P
    assert (v * x * x - u) % P == 0
    if x & 1 != sign:
        x = (P - x) % P
    return x


_BX = _recover_x_int(_BY, 0)

IDENTITY_INT = (0, 1, 1, 0)
BASE_INT = (_BX, _BY, 1, _BX * _BY % P)


def _ext_add_int(p, q):
    """Complete extended addition on Python-int coordinates (host)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2_INT % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _base_table_host() -> np.ndarray:
    """(16, 3, 20) int32: v*B for v in [0,16) in affine-Niels form
    (y+x, y-x, 2d*x*y), computed exactly on the host with Python ints."""
    rows = []
    pt = IDENTITY_INT
    for _ in range(TSIZE):
        x, y, z, _t = pt
        zinv = pow(z, P - 2, P)
        xa, ya = x * zinv % P, y * zinv % P
        rows.append(
            [
                field.to_limbs((ya + xa) % P),
                field.to_limbs((ya - xa) % P),
                field.to_limbs(2 * D_INT * xa % P * ya % P),
            ]
        )
        pt = _ext_add_int(pt, BASE_INT)
    return np.stack([np.stack(r) for r in rows])


_BASE_TABLE = _base_table_host()
_BASE_TABLE.setflags(write=False)


def kernel_consts() -> np.ndarray:
    """(1020,) int32 constants the CUDA kernels stage in shared memory:
    the B table (16*3*20), then d, 2d and sqrt(-1) (20 limbs each)."""
    return np.concatenate(
        [
            _BASE_TABLE.reshape(-1),
            field.to_limbs(D_INT),
            field.to_limbs(D2_INT),
            field.to_limbs(SQRT_M1_INT),
        ]
    ).astype(np.int32)


def _base_table8_host() -> np.ndarray:
    """(32, 256, 3, 20) int32: [v * 2^(8j)]B in affine-Niels form
    (y+x, y-x, 2d*x*y), entry j, v. Exact Python-int arithmetic with one
    Montgomery batch inversion of the 8,192 Z coordinates."""
    pts = []
    g = BASE_INT
    for _j in range(WINDOWS8):
        row = IDENTITY_INT
        for _v in range(TSIZE8):
            pts.append(row)
            row = _ext_add_int(row, g)
        for _ in range(8):  # g <- [2^8] g for the next window
            g = _ext_add_int(g, g)

    prefix = [1]
    for p in pts:
        prefix.append(prefix[-1] * p[2] % P)
    inv_acc = pow(prefix[-1], P - 2, P)
    zinvs = [0] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zinvs[i] = prefix[i] * inv_acc % P
        inv_acc = inv_acc * pts[i][2] % P

    out = np.empty((WINDOWS8 * TSIZE8, 3, NLIMB), np.int32)
    for i, (p, zi) in enumerate(zip(pts, zinvs)):
        xa, ya = p[0] * zi % P, p[1] * zi % P
        out[i, 0] = field.to_limbs((ya + xa) % P)
        out[i, 1] = field.to_limbs((ya - xa) % P)
        out[i, 2] = field.to_limbs(2 * D_INT * xa % P * ya % P)
    return out.reshape(WINDOWS8, TSIZE8, 3, NLIMB)


@lru_cache(maxsize=None)
def base_table8(device: torch.device) -> torch.Tensor:
    """The 8-bit fixed-base table on ``device``, built at first use and
    kept: (32, 256, 3, 20) int32, entry-major, so one entry is 240
    contiguous bytes (1,966,080 B in all). K3/K4 read it from global
    memory, where it stays resident in L2."""
    return torch.from_numpy(_base_table8_host()).to(device)


def const_point(coords, batch_ndim: int = 0, device="cpu") -> torch.Tensor:
    """(x, y, z, t) Python ints -> (4, 20, 1 x batch_ndim) constant."""
    return torch.tensor(
        np.stack([field.to_limbs(c) for c in coords]), device=device
    ).reshape((4, NLIMB) + (1,) * batch_ndim)


def broadcast_point(point: torch.Tensor, batch_shape) -> torch.Tensor:
    """A (4, 20, ...) point viewed as (4, 20, *batch_shape)."""
    return point.reshape(point.shape[:2] + (1,) * len(batch_shape)).expand(
        point.shape[:2] + tuple(batch_shape))


def _const_point(coords, batch_shape, device) -> torch.Tensor:
    return broadcast_point(const_point(coords, 0, device), batch_shape)


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition of two extended points (9 field muls)."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    x2, y2, z2, t2 = q[0], q[1], q[2], q[3]
    a = mul(sub(y1, x1), sub(y2, x2))
    b = mul(add(y1, x1), add(y2, x2))
    c = mul(mul(t1, field.const(D2_INT, t1)), t2)
    d = dbl2(mul(z1, z2))
    e = sub(b, a)
    f = sub(d, c)
    g = add(d, c)
    h = add(b, a)
    return torch.stack([mul(e, f), mul(g, h), mul(f, g), mul(e, h)])


def point_double(p: torch.Tensor) -> torch.Tensor:
    """Complete doubling (4 squarings + 4 muls)."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = sq(x1)
    b = sq(y1)
    c = dbl2(sq(z1))
    h = add(a, b)
    e = sub(h, sq(add(x1, y1)))
    g = sub(a, b)
    f = add(c, g)
    return torch.stack([mul(e, f), mul(g, h), mul(f, g), mul(e, h)])


def point_double_n(p: torch.Tensor, n: int) -> torch.Tensor:
    """n consecutive doublings, skipping T on all but the last (a doubling
    reads only X, Y, Z): one field mul saved a doubling."""
    x1, y1, z1 = p[0], p[1], p[2]
    for _ in range(n):
        a = sq(x1)
        b = sq(y1)
        c = dbl2(sq(z1))
        h = add(a, b)
        e = sub(h, sq(add(x1, y1)))
        g = sub(a, b)
        f = add(c, g)
        x1, y1, z1 = mul(e, f), mul(g, h), mul(f, g)
    return torch.stack([x1, y1, z1, mul(e, h)])


def point_neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([neg(p[0]), p[1], p[2], neg(p[3])])


def to_niels(p: torch.Tensor) -> torch.Tensor:
    """Extended point -> projective-Niels (Y+X, Y-X, 2Z, 2dT): one mul."""
    x, y, z, t = p[0], p[1], p[2], p[3]
    return torch.stack(
        [add(y, x), sub(y, x), dbl2(z), mul(t, field.const(D2_INT, t))]
    )


def to_affine_niels(p: torch.Tensor) -> torch.Tensor:
    """Affine (Z==1) extended point -> (Y+X, Y-X, 2dT): one mul."""
    x, y, t = p[0], p[1], p[3]
    return torch.stack(
        [add(y, x), sub(y, x), mul(t, field.const(D2_INT, t))]
    )


def niels_add(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """p + Q where Q is in projective-Niels form (8 field muls)."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    u2, v2, w2, t2d = n[0], n[1], n[2], n[3]
    a = mul(sub(y1, x1), v2)
    b = mul(add(y1, x1), u2)
    c = mul(t1, t2d)
    d = mul(z1, w2)
    e = sub(b, a)
    f = sub(d, c)
    g = add(d, c)
    h = add(b, a)
    return torch.stack([mul(e, f), mul(g, h), mul(f, g), mul(e, h)])


def affine_niels_add(p: torch.Tensor, n3: torch.Tensor) -> torch.Tensor:
    """p + Q where Q is affine-Niels (y+x, y-x, 2dxy), Z == 1: 7 muls."""
    x1, y1, z1, t1 = p[0], p[1], p[2], p[3]
    u2, v2, t2d = n3[0], n3[1], n3[2]
    a = mul(sub(y1, x1), v2)
    b = mul(add(y1, x1), u2)
    c = mul(t1, t2d)
    d = dbl2(z1)
    e = sub(b, a)
    f = sub(d, c)
    g = add(d, c)
    h = add(b, a)
    return torch.stack([mul(e, f), mul(g, h), mul(f, g), mul(e, h)])


def is_identity(p: torch.Tensor) -> torch.Tensor:
    """True where p == O, i.e. X == 0 and Y == Z (projective)."""
    return is_zero(p[0]) & is_zero(sub(p[1], p[2]))


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor):
    """Batched ZIP-215 point decompression.

    ``y_limbs``: (20, *B) limbs of the 255-bit y encoding, possibly
    non-canonical (y >= p), which ZIP-215 accepts; lazy reduction makes
    that free. ``sign``: (*B,) 0/1 x-parity bit. "Negative zero"
    (x == 0, sign == 1) is accepted: the parity flip on x = 0 is a no-op.

    Returns (point (4, 20, *B), ok (*B,) bool).
    """
    one = field.const(1, y_limbs).expand(y_limbs.shape)
    yy = sq(y_limbs)
    u = sub(yy, one)
    v = add(mul(field.const(D_INT, yy), yy), one)
    v3 = mul(sq(v), v)
    v7 = mul(sq(v3), v)
    x = mul(mul(u, v3), field.pow_2_252_m3(mul(u, v7)))
    vxx = mul(v, sq(x))
    root_ok = eq(vxx, u)
    flip_ok = eq(vxx, neg(u))
    x = torch.where(flip_ok[None], mul(x, field.const(SQRT_M1_INT, x)), x)
    ok = root_ok | flip_ok
    xc = canonical(x)
    parity = xc[0] & 1
    x = torch.where((parity != sign)[None], neg(xc), xc)
    point = torch.stack([x, y_limbs, one, mul(x, y_limbs)])
    return point, ok


def _build_a_table(a_pt: torch.Tensor) -> torch.Tensor:
    """Per-lane table [O, A, 2A, ..., 15A] in projective-Niels form.

    a_pt: (4, 20, *B) decompressed pubkey (affine, Z=1). Returns
    (16, 4, 20, *B): one double, 13 affine-Niels adds, one batched
    conversion.
    """
    batch = a_pt.shape[2:]
    a_niels3 = to_affine_niels(a_pt)
    entries = [a_pt, point_double(a_pt)]
    for _ in range(2, TSIZE - 1):
        entries.append(affine_niels_add(entries[-1], a_niels3))
    # (15, 4, 20, *B) -> (4, 20, 15, *B): limbs back on axis 0 per coord
    stacked = torch.movedim(torch.stack(entries), 0, 2)
    niels = torch.movedim(to_niels(stacked), 2, 0)  # (15, 4, 20, *B)
    ident = _const_point((1, 1, 2, 0), batch, a_pt.device)[None]
    return torch.cat([ident, niels], dim=0)


def _select(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row select: table (16, *rest, *B), idx (*B,) in [0, 16)."""
    iota = torch.arange(TSIZE, dtype=torch.int32, device=idx.device)
    onehot = (idx[None] == iota.reshape((TSIZE,) + (1,) * idx.dim())).to(
        torch.int32
    )
    oh = onehot.reshape(
        (TSIZE,) + (1,) * (table.dim() - 1 - idx.dim()) + tuple(idx.shape)
    )
    return torch.sum(oh * table, dim=0, dtype=torch.int32)


def build_pubkey_tables(y_a: torch.Tensor, sign_a: torch.Tensor):
    """Decompress pubkeys and expand their 16-entry Niels tables.

    The device half of the expanded-pubkey cache (ops/verify.
    PubkeyTableCache): the ~254-squaring sqrt chain and the table build
    are paid once per key instead of once per launch.

    Returns (table (16, 4, 20, *B) int32, ok (*B,) bool).
    """
    a_pt, ok = decompress(y_a, sign_a)
    return _build_a_table(a_pt), ok


def _ladder(table_a, r_pt, s_nibs, kneg_nibs):
    """[8]([S]B + [-k]A - R) == O from A's table and decompressed R."""
    batch = r_pt.shape[2:]
    table_b = torch.tensor(_BASE_TABLE, device=r_pt.device).reshape(
        (TSIZE, 3, NLIMB) + (1,) * len(batch)
    )
    acc = _const_point(IDENTITY_INT, batch, r_pt.device)
    for j in range(WINDOWS):
        for _ in range(WBITS):
            acc = point_double(acc)
        acc = niels_add(acc, _select(table_a, kneg_nibs[j]))
        acc = affine_niels_add(acc, _select(table_b, s_nibs[j]))
    # subtract R: add the affine-Niels form of -R = (-x, y, -t)
    acc = affine_niels_add(acc, to_affine_niels(point_neg(r_pt)))
    acc = point_double(point_double(point_double(acc)))
    return is_identity(acc)


def verify_kernel_cached(
    table_a: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_nibs: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """Cofactored verification with a pre-expanded pubkey table.

    Same math as :func:`verify_kernel` minus A's decompression and table
    build. Returns (*B,) bool; the caller ANDs in the cached per-key
    decompress-ok bits.
    """
    r_pt, ok_r = decompress(y_r, sign_r)
    return _ladder(table_a, r_pt, s_nibs, kneg_nibs) & ok_r


def _slot_tables(arena, arena_ok, idxs):
    """Each lane's table from a (16, 4, 20, S) arena by its uint16 slot
    (``idxs`` (N,) int16), and the slot's ok bit; a slot >= S reads slot 0
    and gets ok False."""
    slots = arena.shape[-1]
    sel = idxs.to(torch.int64) & 0xFFFF
    in_range = sel < slots
    sel = torch.where(in_range, sel, torch.zeros_like(sel))
    return arena[..., sel], arena_ok[sel] & in_range


def verify_kernel_slots(
    arena: torch.Tensor,
    arena_ok: torch.Tensor,
    idxs: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_nibs: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """:func:`verify_kernel_cached` on lanes that name their table by slot.

    ``arena`` (16, 4, 20, S) int32 and ``arena_ok`` (S,) bool are a pubkey
    arena; ``idxs`` (N,) int16 holds uint16 slot numbers. The plain version
    of the cached kernel K2: it gathers each lane's table and ANDs in the
    slot's ok bit. A slot >= S verifies False.
    """
    table, ok = _slot_tables(arena, arena_ok, idxs)
    return verify_kernel_cached(table, y_r, sign_r, s_nibs, kneg_nibs) & ok


def verify_kernel(
    y_a: torch.Tensor,
    sign_a: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_nibs: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """Batched cofactored ed25519 verification.

    Inputs (B = batch shape, limb/window axes lead):
      y_a, y_r:        (20, *B) y-limbs of pubkey A and signature point R
      sign_a, sign_r:  (*B,)    x-parity bits
      s_nibs:          (64, *B) 4-bit windows of S, MSB first (host checks S < L)
      kneg_nibs:       (64, *B) 4-bit windows of (-k mod L), k = SHA512(R||A||M) mod L

    Returns (*B,) bool: [8]([S]B + [-k]A - R) == O and both points decoded.
    """
    # decompress A and R as one stacked batch: (20, 2, *B)
    pts, oks = decompress(
        torch.stack([y_a, y_r], dim=1), torch.stack([sign_a, sign_r], dim=0)
    )
    a_pt, r_pt = pts[:, :, 0], pts[:, :, 1]
    table_a = _build_a_table(a_pt)
    return _ladder(table_a, r_pt, s_nibs, kneg_nibs) & oks[0] & oks[1]


# ------------------------------------------------------------ 8-bit flavor


def fixed_base_sum8(s_bytes: torch.Tensor) -> torch.Tensor:
    """[S]B from little-endian S bytes: (32, *B) int32 in [0, 256), byte j
    the window of weight 2^(8j). Returns an extended point (4, 20, *B):
    32 affine-Niels adds from the identity, no doublings. A byte is read
    modulo 256, as the kernels read it."""
    batch = tuple(s_bytes.shape[1:])
    table = base_table8(s_bytes.device)
    win = torch.arange(WINDOWS8, device=s_bytes.device).reshape(
        (WINDOWS8,) + (1,) * len(batch)
    )
    sel = table[win, (s_bytes & (TSIZE8 - 1)).to(torch.int64)]
    sel = torch.movedim(sel, (-2, -1), (1, 2))  # (32, 3, 20, *B)
    acc = _const_point(IDENTITY_INT, batch, s_bytes.device)
    for j in range(WINDOWS8):
        acc = affine_niels_add(acc, sel[j])
    return acc


def _ladder_a_only(table_a, kneg_nibs, batch, device):
    """The joint ladder minus its B part: [(-k mod L)]A."""
    acc = _const_point(IDENTITY_INT, batch, device)
    for j in range(WINDOWS):
        for _ in range(WBITS):
            acc = point_double(acc)
        acc = niels_add(acc, _select(table_a, kneg_nibs[j]))
    return acc


def _finish8(table_a, r_pt, s_bytes, kneg_nibs):
    """[8]([k']A + [S]B - R) == O with [S]B from the 8-bit windows."""
    batch = r_pt.shape[2:]
    acc = point_add(
        _ladder_a_only(table_a, kneg_nibs, batch, r_pt.device),
        fixed_base_sum8(s_bytes),
    )
    acc = affine_niels_add(acc, to_affine_niels(point_neg(r_pt)))
    acc = point_double(point_double(point_double(acc)))
    return is_identity(acc)


def verify_kernel8(
    y_a: torch.Tensor,
    sign_a: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_bytes: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """:func:`verify_kernel` with [S]B on 8-bit fixed-base windows: the
    plain version of K3. ``s_bytes`` is (32, *B) little-endian S bytes;
    ``kneg_nibs`` stays (64, *B) 4-bit windows, MSB first."""
    pts, oks = decompress(
        torch.stack([y_a, y_r], dim=1), torch.stack([sign_a, sign_r], dim=0)
    )
    a_pt, r_pt = pts[:, :, 0], pts[:, :, 1]
    table_a = _build_a_table(a_pt)
    return _finish8(table_a, r_pt, s_bytes, kneg_nibs) & oks[0] & oks[1]


def verify_kernel8_cached(
    table_a: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_bytes: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """:func:`verify_kernel_cached` with 8-bit fixed-base [S]B windows.
    The caller ANDs in the cached per-key decompress-ok bits."""
    r_pt, ok_r = decompress(y_r, sign_r)
    return _finish8(table_a, r_pt, s_bytes, kneg_nibs) & ok_r


def verify_kernel8_slots(
    arena: torch.Tensor,
    arena_ok: torch.Tensor,
    idxs: torch.Tensor,
    y_r: torch.Tensor,
    sign_r: torch.Tensor,
    s_bytes: torch.Tensor,
    kneg_nibs: torch.Tensor,
) -> torch.Tensor:
    """:func:`verify_kernel8_cached` on lanes that name their table by
    uint16 slot in a pubkey arena: the plain version of K4, with the
    contract of :func:`verify_kernel_slots`. A slot >= S verifies False."""
    table, ok = _slot_tables(arena, arena_ok, idxs)
    return verify_kernel8_cached(table, y_r, sign_r, s_bytes, kneg_nibs) & ok
