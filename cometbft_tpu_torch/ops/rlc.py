"""Device RLC batch verification: ONE multiscalar multiplication.

The port of cometbft_tpu/ops/rlc.py. The batch equation behind the
reference's batch verifier (crypto/ed25519/ed25519.go:200-228,
types/validation.go:243-250), with per-lane 128-bit random z_i drawn on
the host:

    [8]( [sum z_i s_i]B  -  sum [z_i k_i]A_i  -  sum [z_i]R_i ) == O

run as one Pippenger multiscalar multiplication over the batch instead
of a double-scalar ladder a lane (K1/K2, ~3,400 field products a
signature). :func:`op_ledger` gives the static count.

* The host half gives the reference's arrays exactly: lane counts bucket
  to powers of two (at least 8), the window width is a function of the
  bucket, scalars recode to signed base-2^c digits, and the plan of a
  side (``perm``, ``sign``, ``starts``, ``ends``: int32) sorts each
  window's lanes by |digit| so that bucket v is the segment
  [starts[j, v-1], ends[j, v-1]) of the sorted lanes. Lanes of digit 0,
  pad lanes among them, sit before the first segment and are never
  summed. Digits and y limbs are read as bit fields of 64-bit words, and
  the fold multiplies a lane's scalars in one pass of ``map``, where the
  reference unpacks every bit and loops in Python: the same arrays and
  ints, in a fraction of the host time.
* The device half is X5 (csrc/rlc.cu through ops/cuda_rlc.py), which
  computes what :func:`_rlc_kernel` computes: decompress (an undecodable
  point becomes the identity and fails the all-ok bit), bucket sums,
  window sums sum_v v B_v, Horner over the windows, [b]B, three
  doublings and the identity test. :func:`_rlc_kernel` and the functions
  under it are the plain PyTorch version: what a CPU tensor runs and what
  the kernel is held against on the card. Their prefix sums are a
  log-step scan (torch has no associative_scan), chunked over windows so
  that 65,536 lanes stay inside a few hundred MB. The association order
  differs from the reference's and from X5's, which changes limbs but not
  points: compare window sums and totals as encodings (:func:`encode`).
* Distinct-key folding: sum [z_i k_i]A_i groups by key on the host, one
  point a distinct key with coefficient sum(z_i k_i) mod L; R is negated
  by flipping its encoding's sign bit, exact under ZIP-215 (x == 0
  included), so R's coefficients stay 128-bit.

Failure contract (types/validation.go:243-250): the equation is all or
nothing. On False :func:`verify_batch_rlc` attributes every lane through
ops.verify.verify_batch (K2 on the process-wide arena by default). That
is the algorithm, not a fallback: an X5 build or launch error raises.
"""

from __future__ import annotations

import operator
import secrets

import numpy as np
import torch

from . import curve, field

L = curve.L

# Lane counts are bucketed to powers of two; the window width c is then a
# function of the bucket, so each (A bucket, R bucket) pair is one shape.
_MIN_BUCKET = 8
A_BITS = 253  # folded A coefficients are taken mod L
R_BITS = 128  # R's coefficients are the 128-bit z_i
# lanes x windows of one chunk of the plain scan: a (4, 20, W, N) point
# array of this size is 10 MB, a field product's (20, 40, W, N) 400 MB
_PLAIN_CHUNK = 1 << 17


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def window_bits(n_points: int, nbits: int) -> int:
    """Pick the Pippenger window width minimizing the static add count.

    Cost model per window: 2N (prefix scan) + 5 * 2^(c-1) (bucket
    extraction + suffix scan + tree reduce); windows = ceil(nbits/c) + 1
    (signed-recode carry window). Exact argmin over c in [4, 12].
    """
    best_c, best_cost = 4, None
    for c in range(4, 13):
        w = -(-nbits // c) + 1
        cost = w * (2 * n_points + 5 * (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def windows(c: int, nbits: int) -> int:
    """Signed-digit windows of an ``nbits`` scalar at width c."""
    return -(-nbits // c) + 1


def _words(rows: np.ndarray, n_words: int) -> np.ndarray:
    """(N, 32) uint8 little-endian rows -> (N, n_words) uint64 words, the
    words past the row's four zero."""
    out = np.zeros((rows.shape[0], n_words), np.uint64)
    out[:, :4] = np.ascontiguousarray(rows, dtype=np.uint8).view("<u8")
    return out


def _bit_field(words: np.ndarray, offset: int, width: int) -> np.ndarray:
    """Bits [offset, offset + width) of each row's words, width < 64."""
    wi, sh = divmod(offset, 64)
    v = words[:, wi] >> np.uint64(sh)
    if sh + width > 64:
        v |= words[:, wi + 1] << np.uint64(64 - sh)
    return v & np.uint64((1 << width) - 1)


def signed_digits(scalars: np.ndarray, c: int, nbits: int) -> np.ndarray:
    """(N, 32) LE scalar bytes -> (W, N) signed base-2^c digits.

    Digits lie in [-2^(c-1), 2^(c-1)]; scalar == sum d_j * 2^(c*j). Each
    window's c bits are read from the scalar's 64-bit words (bits past
    256 are zero), then one carry sweep across the W windows: the
    reference's digits, without its (N, 256) bit array.
    """
    n = scalars.shape[0]
    w = windows(c, nbits)
    words = _words(scalars, -(-(w * c) // 64) + 1)
    half = 1 << (c - 1)
    carry = np.zeros(n, np.int32)
    out = np.empty((w, n), np.int32)
    for j in range(w):
        t = _bit_field(words, c * j, c).astype(np.int32) + carry
        hi = t >= half
        out[j] = np.where(hi, t - (1 << c), t)
        carry = hi.astype(np.int32)
    assert not carry.any(), "signed recode overflow: widen W"
    return out


def plan_msm(scalars: np.ndarray, c: int, nbits: int):
    """Host-side MSM plan: everything data-dependent, none of it device.

    Returns dict of int32 arrays: perm (W, N) sorted-order lane indices,
    sign (W, N) 0/1 negate-the-point mask in SORTED order, starts/ends
    (W, m) prefix-scan segment boundaries per bucket value 1..m.
    """
    digits = signed_digits(scalars, c, nbits)
    w, n = digits.shape
    m = 1 << (c - 1)
    absd = np.abs(digits)
    perm = np.argsort(absd, axis=1).astype(np.int32)
    sorted_abs = np.take_along_axis(absd, perm, axis=1)
    sign = np.take_along_axis((digits < 0).astype(np.int32), perm, axis=1)
    vals = np.arange(1, m + 1, dtype=np.int32)
    starts = np.empty((w, m), np.int32)
    ends = np.empty((w, m), np.int32)
    for j in range(w):
        starts[j] = np.searchsorted(sorted_abs[j], vals, side="left")
        ends[j] = np.searchsorted(sorted_abs[j], vals, side="right")
    return {"perm": perm, "sign": sign, "starts": starts, "ends": ends}


PLAN_KEYS = ("perm", "sign", "starts", "ends")


# --------------------------------------------------- device, plain version


def _scan(pts: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of points along the last axis: log-step."""
    n = pts.shape[-1]
    d = 1
    while d < n:
        pts = torch.cat([pts[..., :d],
                         curve.point_add(pts[..., d:], pts[..., :-d])], dim=-1)
        d *= 2
    return pts


def _window_sums(points, perm, sign, starts, ends) -> torch.Tensor:
    """:func:`_msm_window_sums` on one chunk of windows."""
    w = perm.shape[0]
    gathered = points[:, :, perm.long()]  # (4, 20, W, N)
    pts = torch.where(sign[None, None] == 1, curve.point_neg(gathered),
                      gathered)
    prefix = _scan(pts)
    ident = curve._const_point(curve.IDENTITY_INT, (w, 1), points.device)
    prefix0 = torch.cat([ident, prefix], dim=3)

    def at(idx):
        return torch.gather(prefix0, 3,
                            idx.long()[None, None].expand(4, field.NLIMB,
                                                          *idx.shape))

    buckets = curve.point_add(at(ends), curve.point_neg(at(starts)))
    # sum_v v * B_v == sum_v (sum_{u >= v} B_u): suffix scan + tree sum
    suffix = _scan(buckets.flip(3)).flip(3)
    m = suffix.shape[3]
    while m > 1:
        m //= 2
        suffix = curve.point_add(suffix[..., :m], suffix[..., m:])
    return suffix[..., 0]


def _msm_window_sums(points, perm, sign, starts, ends) -> torch.Tensor:
    """Per-window bucket-weighted sums: (4, 20, N) points -> (4, 20, W).

    points: extended coordinates, batch-minor. perm/sign (W, N),
    starts/ends (W, m): gather in sorted order, negate where sign,
    inclusive prefix sums along the lane axis, bucket = prefix[end] -
    prefix[start], then suffix sums and a tree reduce.
    """
    w, n = perm.shape
    step = max(1, _PLAIN_CHUNK // max(1, n))
    return torch.cat([
        _window_sums(points, perm[j:j + step], sign[j:j + step],
                     starts[j:j + step], ends[j:j + step])
        for j in range(0, w, step)], dim=2)


def _horner(wsums: torch.Tensor, c: int) -> torch.Tensor:
    """Combine window sums msb-first: acc = [2^c]acc + W_j. (4,20,W)->(4,20)."""
    w = wsums.shape[2]
    acc = wsums[:, :, w - 1]
    for j in range(w - 2, -1, -1):
        acc = curve.point_add(curve.point_double_n(acc, c), wsums[:, :, j])
    return acc


def _masked_decompress(y, sign):
    """Decompress with undecodable lanes masked to the identity.

    Masked lanes contribute nothing to the MSM sums; the returned ok bits
    still fail the launch so the caller attributes per lane (an
    undecodable point IS an invalid signature)."""
    pts, ok = curve.decompress(y, sign)
    ident = curve._const_point(curve.IDENTITY_INT, y.shape[1:], y.device)
    return torch.where(ok[None, None], pts, ident), ok


def _rlc_parts(y_a, sign_a, plan_a, y_r, sign_r, plan_r, b_bytes, *,
               c_a: int, c_r: int):
    """(A's window sums (4, 20, Wa), R's (4, 20, Wr), the pre-cofactor
    total (4, 20), the bool) of :func:`_rlc_kernel`."""
    a_pts, ok_a = _masked_decompress(y_a, sign_a)
    r_pts, ok_r = _masked_decompress(y_r, sign_r)
    ws_a = _msm_window_sums(a_pts, *plan_a)
    ws_r = _msm_window_sums(r_pts, *plan_r)
    sum_a = _horner(ws_a, c_a)
    sum_r = _horner(ws_r, c_r)
    sb = curve.fixed_base_sum8(b_bytes)[:, :, 0]
    total = curve.point_add(curve.point_add(sb, sum_a), sum_r)
    acc = total
    for _ in range(3):  # cofactor: [8] kills torsion exactly (ZIP-215)
        acc = curve.point_double(acc)
    ok = curve.is_identity(acc) & torch.all(ok_a) & torch.all(ok_r)
    return ws_a, ws_r, total, ok


def _rlc_kernel(y_a, sign_a, plan_a, y_r, sign_r, plan_r, b_bytes, *,
                c_a: int, c_r: int):
    """The full batch equation; returns ONE bool (a 0-d tensor).

    True == every decodable lane satisfies the linear combination AND
    every lane decoded. b_bytes: (32, 1) LE bytes of sum(z_i s_i) mod L.
    """
    return _rlc_parts(y_a, sign_a, plan_a, y_r, sign_r, plan_r, b_bytes,
                      c_a=c_a, c_r=c_r)[3]


def encode(points, bits: int = field.BITS) -> list[bytes]:
    """(4, nlimb, K) extended points (limbs of ``bits`` bits, lazy
    allowed) -> K compressed 32-byte encodings: how window sums and
    totals from different association orders are compared."""
    arr = np.asarray(points.cpu() if isinstance(points, torch.Tensor)
                     else points).astype(np.int64)
    p = field.P
    out = []
    for k in range(arr.shape[2]):
        x, y, z = (sum(int(v) << (bits * i) for i, v in enumerate(arr[c, :, k]))
                   for c in range(3))
        zi = pow(z % p, p - 2, p)
        xa, ya = x * zi % p, y * zi % p
        out.append((ya | (xa & 1) << 255).to_bytes(32, "little"))
    return out


# --------------------------------------------------------------- host


def _enc_arrays(encs: list[bytes], n_pad: int):
    """32-byte point encodings -> (y_limbs (20, n_pad), sign (n_pad,)):
    the 13-bit limbs of bits 0..254 (y >= p stays unreduced: ZIP-215
    accepts it) and bit 255. Pad lanes hold the identity encoding: they
    decode OK (so they never fail the launch) and carry all-zero digits
    (bucket 0, never summed)."""
    padded = np.zeros((n_pad, 32), np.uint8)
    padded[:, 0] = 1  # identity encoding for every pad lane
    padded[: len(encs)] = np.frombuffer(b"".join(encs), np.uint8).reshape(
        len(encs), 32)
    words = _words(padded, 4)
    limbs = np.empty((field.NLIMB, n_pad), np.int32)
    for i in range(field.NLIMB):
        # limb 19 holds bits 247..254: the sign bit is not y's
        width = field.BITS if i < field.NLIMB - 1 else 255 - 13 * i
        limbs[i] = _bit_field(words, field.BITS * i, width)
    return limbs, (padded[:, 31] >> 7).astype(np.int32)


def _scalar_rows(scalars: list[int], n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad, 32), np.uint8)
    if scalars:
        out[: len(scalars)] = np.frombuffer(
            b"".join(s.to_bytes(32, "little") for s in scalars),
            np.uint8).reshape(len(scalars), 32)
    return out


def launch_inputs(a_encs, a_scalars, r_encs, r_scalars, b_scalar) -> dict:
    """The numpy arrays of one X5 launch: y limbs, signs and plans of
    both sides, ``b_bytes`` (32, 1), and the window widths c_a, c_r."""
    na, nr = _bucket(max(1, len(a_encs))), _bucket(max(1, len(r_encs)))
    c_a = window_bits(na, A_BITS)
    c_r = window_bits(nr, R_BITS)
    y_a, sign_a = _enc_arrays(a_encs, na)
    y_r, sign_r = _enc_arrays(r_encs, nr)
    plan_a = plan_msm(_scalar_rows(a_scalars, na), c_a, A_BITS)
    plan_r = plan_msm(_scalar_rows(r_scalars, nr), c_r, R_BITS)
    b_bytes = np.frombuffer(
        b_scalar.to_bytes(32, "little"), np.uint8
    ).astype(np.int32)[:, None]
    return {"y_a": y_a, "sign_a": sign_a,
            "plan_a": tuple(plan_a[k] for k in PLAN_KEYS),
            "y_r": y_r, "sign_r": sign_r,
            "plan_r": tuple(plan_r[k] for k in PLAN_KEYS),
            "b_bytes": b_bytes, "c_a": c_a, "c_r": c_r}


def to_device(inputs: dict, device) -> dict:
    """:func:`launch_inputs` with every array a tensor on ``device``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = dict(inputs)
    for k in ("y_a", "sign_a", "y_r", "sign_r", "b_bytes"):
        out[k] = t(inputs[k])
    for k in ("plan_a", "plan_r"):
        out[k] = tuple(t(a) for a in inputs[k])
    return out


def check_equation(a_encs, a_scalars, r_encs, r_scalars, b_scalar, *,
                   device="cuda") -> bool:
    """Run [8]([b]B + sum [a_s]A + sum [r_s]R) == O on ``device``.

    All scalars are taken mod L by the caller; encodings are 32-byte
    compressed points (callers pre-negate R by flipping the sign bit —
    exact under ZIP-215 including the x == 0 fixed point). On a CUDA
    device X5 runs; on the CPU its plain version.
    """
    from . import cuda_rlc
    from .verify import resolve_device

    dev = resolve_device(device)
    inputs = to_device(
        launch_inputs(a_encs, a_scalars, r_encs, r_scalars, b_scalar), dev)
    return bool(cuda_rlc.rlc_equation(**inputs))


def _le_ints(blob: bytes, width: int) -> list[int]:
    return [int.from_bytes(blob[i:i + width], "little")
            for i in range(0, len(blob), width)]


def fold(buf: np.ndarray, host_ok: np.ndarray, zbytes: bytes):
    """The batch's MSM from its wire rows (ops.verify.pack_bytes) and
    16 random bytes a well-formed lane: (A keys, A scalars, R encodings
    with the sign bit flipped, R scalars, b), the A side folded by
    distinct key in first-seen order. z_i = max(1, zbytes[16 i: 16 i +
    16]) little-endian. -sum [z k]A == +sum [z kneg]A; -R folds into the
    encoding."""
    well = np.nonzero(host_ok)[0]
    rows = np.ascontiguousarray(buf[:, well].T)  # (k, 128)
    zints = [max(1, z) for z in _le_ints(zbytes[:16 * len(well)], 16)]
    a_blob = rows[:, 0:32].tobytes()
    a_fold: dict[bytes, int] = {}
    for i, p in zip(range(0, len(a_blob), 32),
                    map(operator.mul, zints,
                        _le_ints(rows[:, 96:128].tobytes(), 32))):
        key = a_blob[i:i + 32]
        a_fold[key] = a_fold.get(key, 0) + p
    b = sum(map(operator.mul, zints,
                _le_ints(rows[:, 64:96].tobytes(), 32))) % L
    r_rows = rows[:, 32:64].copy()
    r_rows[:, 31] ^= 0x80
    r_blob = r_rows.tobytes()
    r_encs = [r_blob[i:i + 32] for i in range(0, len(r_blob), 32)]
    return (list(a_fold), [v % L for v in a_fold.values()], r_encs, zints,
            b)


def verify_batch_rlc(pubkeys, msgs, sigs, *, device="cuda"):
    """Batch-verify via the RLC equation; per-lane attribution on fail.

    Same (all_valid, bitmap) contract as ops.verify.verify_batch. The
    happy path runs X5 once; any invalid or undecodable lane fails the
    single equation and ops.verify.verify_batch attributes every lane
    (reference discipline: types/validation.go:243-250). The z_i come
    fresh from ``secrets`` on every call, never revealed, so a forged
    lane passes with p ~ 2^-128.
    """
    from . import verify as _v

    dev = _v.resolve_device(device)
    n = len(pubkeys)
    if n == 0:
        return True, np.zeros(0, bool)
    buf, host_ok = _v.pack_bytes(pubkeys, msgs, sigs)
    k = int(host_ok.sum())
    if k == 0:
        return False, host_ok
    zbytes = secrets.token_bytes(16 * k)
    if check_equation(*fold(buf, host_ok, zbytes), device=dev):
        return bool(host_ok.all()), host_ok
    return _v.verify_batch(pubkeys, msgs, sigs, device=dev)


# -------------------------------------------------------------- ledger


def op_ledger(n_lanes: int, n_keys: int | None = None) -> dict:
    """Static field-mul count for one RLC launch (no measurement).

    Every add is 9 muls (complete extended add), every doubling 7-8,
    decompression 265 (the 2^252-3 chain). ``n_keys`` defaults to
    all-distinct.
    """
    n_keys = n_lanes if n_keys is None else n_keys
    na, nr = _bucket(max(1, n_keys)), _bucket(max(1, n_lanes))
    total_adds = 0.0
    total_dbls = 0.0
    for n_pts, nbits in ((na, A_BITS), (nr, R_BITS)):
        c = window_bits(n_pts, nbits)
        w = windows(c, nbits)
        m = 1 << (c - 1)
        total_adds += w * (2 * n_pts + 1 + 5 * m)  # scan+extract+aggregate
        total_adds += w - 1  # horner adds
        total_dbls += (w - 1) * c  # horner doublings
    total_adds += 32 + 2 + 1  # fixed-base [b]B + final combine
    total_dbls += 3  # cofactor
    decompress = 265 * (na + nr)
    muls = total_adds * 9 + total_dbls * 8 + decompress
    return {
        "adds": int(total_adds),
        "doublings": int(total_dbls),
        "decompress_muls": int(decompress),
        "field_muls_total": int(muls),
        "field_muls_per_sig": round(muls / max(1, n_lanes), 1),
        "msm_muls_per_sig": round(total_adds * 9 / max(1, n_lanes), 1),
    }
