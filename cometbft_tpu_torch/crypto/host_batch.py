"""Host ed25519 batch verification over the native MSM engine.

The host tier of batch verification (the reference's curve25519-voi
batch verify, crypto/ed25519/ed25519.go:196-228): draw random 128-bit
coefficients z_i and check the one random-linear-combination equation

    [8]( [sum z_i S_i]B - sum [z_i k_i]A_i - sum [z_i]R_i ) == O

with one multiscalar multiplication. Python does the admission filter
(lengths, S < L) and draws the coefficients; native/edbatch.cpp, this
package's own copy built by libs/native_build.py, does the SHA-512
challenges, the coefficient arithmetic mod L, ZIP-215 decompression and
the Pippenger MSM, through ctypes (every call releases the GIL).

It serves the batches below the device crossover (crypto/batch.py), the
verify coalescer's small windows (crypto/coalesce.py), and the challenge
packing of ops/verify.pack_bytes (:func:`pack_challenges`). Its sr25519
half serves crypto/sr25519.py: the merlin challenges
(:func:`sr_challenge_batch`), ristretto255 -> Edwards conversion
(:func:`ristretto_to_edwards_batch`), the keccak-f[1600] permutation of
the transcripts, the constant-time [s]B of signing, and the RLC verdict
over precomputed (A, R, s, k) quads (:func:`verify_quads`).

Soundness: an invalid signature passes the RLC check with probability
~2^-128 over the coefficient draw (z_i from ``secrets``). On a failing
batch, lanes are attributed by binary splitting with the same
coefficients, ending in single cofactored checks through the same MSM
core, so every per-lane verdict has exact ZIP-215 semantics.

No fallback: when the engine does not build or load, every call raises
:class:`~cometbft_tpu_torch.libs.native_build.NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import secrets
from pathlib import Path

import numpy as np

from ..libs import native_build
from ..libs import sync as libsync
from . import ed25519_ref as ref

L = ref.L
_B_ENC = bytes([0x58]) + bytes([0x66]) * 31  # compressed base point

SRC = Path(__file__).resolve().parents[1] / "native" / "edbatch.cpp"

_load_lock = libsync.Mutex("crypto.host_batch._build_lock")
_lib = None


def _load():
    """The native engine, built and bound at first use; raises
    NativeBuildError when it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is None:
            lib = native_build.build_and_load(SRC)
            _bind(lib)
            _install_sha512_constants(lib)
            _lib = lib
    return _lib


def _bind(lib) -> None:
    """ctypes signatures of the engine's symbols."""
    lib.edb_msm_is_identity_x8.restype = ctypes.c_long
    lib.edb_msm_is_identity_x8.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.edb_decompress_ok.restype = None
    lib.edb_decompress_ok.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
    ]
    lib.edb_sha512_set_constants.restype = None
    lib.edb_sha512_set_constants.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.edb_pack_challenges.restype = ctypes.c_long
    lib.edb_pack_challenges.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.edb_verify_batch.restype = ctypes.c_long
    lib.edb_verify_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.edb_scalar_base_mult_xy.restype = None
    lib.edb_scalar_base_mult_xy.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.edb_keccak_f1600.restype = None
    lib.edb_keccak_f1600.argtypes = [ctypes.c_void_p]
    lib.edb_sr_challenge_batch.restype = ctypes.c_long
    lib.edb_sr_challenge_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.edb_ristretto_to_edwards.restype = None
    lib.edb_ristretto_to_edwards.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_char_p,
    ]


def _install_sha512_constants(lib) -> None:
    """Compute the FIPS 180-4 SHA-512 constants from their definition
    (the first 64 fractional bits of the cube and square roots of the
    first primes, in exact integer arithmetic) and install them in the
    engine."""
    primes = []
    cand = 2
    while len(primes) < 80:
        if all(cand % p for p in primes):
            primes.append(cand)
        cand += 1

    def iroot(x: int, k: int) -> int:
        """Exact integer k-th root by Newton's method."""
        if x == 0:
            return 0
        r = 1 << ((x.bit_length() + k - 1) // k)
        while True:
            nr = ((k - 1) * r + x // r ** (k - 1)) // k
            if nr >= r:
                break
            r = nr
        return r

    def frac_bits(p: int, k: int) -> int:
        # floor(frac(p^(1/k)) * 2^64)
        return iroot(p << (64 * k), k) - (iroot(p, k) << 64)

    k80 = (ctypes.c_uint64 * 80)(*[frac_bits(p, 3) for p in primes])
    h8 = (ctypes.c_uint64 * 8)(*[frac_bits(p, 2) for p in primes[:8]])
    lib.edb_sha512_set_constants(k80, h8)


def available() -> bool:
    """True once the engine is built and loaded; raises when it cannot
    be."""
    return _load() is not None


def _offsets(offs, n: int) -> np.ndarray:
    offs_arr = np.ascontiguousarray(offs, np.uint64)
    if offs_arr.shape != (n + 1,):
        raise ValueError(f"offs must hold n + 1 = {n + 1} offsets")
    return offs_arr


def pack_challenges(recs: bytes, msgs_blob: bytes, offs, n: int):
    """Per-lane challenges for ops/verify.pack_bytes.

    ``recs``: n x 96 bytes (A|R|S); ``msgs_blob`` + ``offs`` (n+1 uint64
    offsets): the concatenated sign bytes. Returns (the n rows of -k mod L,
    32n bytes; s_ok (n,) bool, S < L)."""
    lib = _load()
    out_kneg = ctypes.create_string_buffer(32 * n)
    out_ok = ctypes.create_string_buffer(n)
    offs_arr = _offsets(offs, n)
    rc = lib.edb_pack_challenges(
        recs, msgs_blob, offs_arr.ctypes.data, n, out_kneg, out_ok
    )
    if rc != 0:
        raise RuntimeError(f"edb_pack_challenges failed ({rc})")
    return out_kneg.raw, np.frombuffer(out_ok.raw, np.uint8).astype(bool)


def sr_challenge_batch(ctx_state: bytes, recs: bytes, msgs_blob: bytes,
                       offs, n: int) -> bytes:
    """Batched sr25519 (schnorrkel) verification challenges.

    ``ctx_state``: the 203-byte serialized STROBE state of the merlin
    transcript prefix Transcript("SigningContext") + append("", context)
    (crypto/sr25519._context_prefix); ``recs``: n x 64 bytes (pk | R);
    ``msgs_blob`` + ``offs`` (n+1 uint64 offsets): the concatenated sign
    bytes. Returns n x 32 bytes, each challenge k_i mod L little-endian
    (the reference's crypto/sr25519/batch.go:14-46)."""
    if len(ctx_state) != 203:
        raise ValueError("ctx_state must be the 203-byte STROBE state")
    if len(recs) != 64 * n:
        raise ValueError(f"recs must hold 64 * n = {64 * n} bytes")
    lib = _load()
    offs_arr = _offsets(offs, n)
    if int(offs_arr[-1]) != len(msgs_blob):
        raise ValueError("offs must end at len(msgs_blob)")
    if n == 0:
        return b""
    out_k = ctypes.create_string_buffer(32 * n)
    rc = lib.edb_sr_challenge_batch(
        bytes(ctx_state), bytes(recs), bytes(msgs_blob),
        offs_arr.ctypes.data, n, out_k
    )
    if rc != 0:
        raise RuntimeError(f"edb_sr_challenge_batch failed ({rc})")
    return out_k.raw


def ristretto_to_edwards_batch(encs: bytes, m: int):
    """Decode m ristretto255 encodings (RFC 9496) and compress each point
    as an Edwards encoding: (32*m bytes of encodings, ok (m,) bool, True
    where the input is a valid canonical ristretto encoding). Both sr25519
    batch consumers, the host MSM and the device kernels, take compressed
    Edwards points."""
    if len(encs) != 32 * m:
        raise ValueError(f"encs must hold 32 * m = {32 * m} bytes")
    lib = _load()
    if m == 0:
        return b"", np.zeros(0, bool)
    out_enc = ctypes.create_string_buffer(32 * m)
    out_ok = ctypes.create_string_buffer(m)
    lib.edb_ristretto_to_edwards(bytes(encs), m, out_enc, out_ok)
    return out_enc.raw, np.frombuffer(out_ok.raw, np.uint8).astype(bool)


def keccak_f1600_inplace(state: bytearray) -> None:
    """The keccak-f[1600] permutation of a 200-byte state (little-endian
    lanes), in place: the merlin/STROBE transcripts of crypto/sr25519.py
    permute through it."""
    if not isinstance(state, bytearray) or len(state) != 200:
        raise ValueError("state must be a 200-byte bytearray")
    lib = _load()
    buf = (ctypes.c_ubyte * 200).from_buffer(state)
    lib.edb_keccak_f1600(ctypes.addressof(buf))


def scalar_base_mult(scalar: int):
    """[s]B as an extended-coordinate point (x, y, 1, xy), the signing
    primitive of sr25519: the engine selects table entries with arithmetic
    masks, with no load or branch indexed by the secret scalar."""
    lib = _load()
    out = ctypes.create_string_buffer(64)
    lib.edb_scalar_base_mult_xy((scalar % L).to_bytes(32, "little"), out)
    x = int.from_bytes(out.raw[:32], "little")
    y = int.from_bytes(out.raw[32:], "little")
    return (x, y, 1, x * y % ref.P)


def _msm_identity(points: bytes, coeffs: bytes, m: int) -> int:
    return _load().edb_msm_is_identity_x8(points, coeffs, m)


def _decompress_ok(encs: bytes, m: int) -> np.ndarray:
    out = ctypes.create_string_buffer(m)
    _load().edb_decompress_ok(encs, m, out)
    return np.frombuffer(out.raw, np.uint8).astype(bool)


class _Lane:
    __slots__ = ("a", "r", "s", "k", "z")

    def __init__(self, a, r, s, k, z):
        self.a, self.r, self.s, self.k, self.z = a, r, s, k, z


def _check_lanes_res(lanes) -> int:
    """One RLC MSM over ``lanes``: 1 all valid, 0 the equation fails,
    -(2+i) when MSM input point i does not decode (the engine decodes
    before any bucket work)."""
    m = 2 * len(lanes) + 1
    points = bytearray()
    coeffs = bytearray()
    b = 0
    for ln in lanes:
        b = (b + ln.z * ln.s) % L
        points += ln.a
        coeffs += ((-(ln.z * ln.k)) % L).to_bytes(32, "little")
        # -R with coefficient +z (128-bit) instead of R with L - z
        # (252-bit): negation is a sign-bit flip of the encoding (exact
        # under ZIP-215, x == 0 included), and short coefficients skip
        # half the Pippenger windows.
        points += ln.r[:31] + bytes([ln.r[31] ^ 0x80])
        coeffs += ln.z.to_bytes(32, "little")
    points += _B_ENC
    coeffs += b.to_bytes(32, "little")
    return _msm_identity(bytes(points), bytes(coeffs), m)


def _check_lanes(lanes) -> bool:
    """True iff every lane is valid; callers pass decodable points only."""
    res = _check_lanes_res(lanes)
    if res < 0:  # filtered upstream: a residual one is a bug
        raise RuntimeError(f"unexpected decompress failure at {-res - 2}")
    return res == 1


def _verdict_lanes(lanes, out, idx_map, res=None) -> None:
    """Per-lane verdicts of built lanes: one MSM (or ``res``, a verdict
    already taken over exactly these lanes and coefficients); on an
    undecodable point, drop the lanes that hold one and check again; on a
    failing equation, attribute by binary splitting."""
    if not lanes:
        return
    if res is None:
        res = _check_lanes_res(lanes)
    if res == 1:
        for i in idx_map:
            out[i] = True
        return
    if res < 0:
        enc = b"".join(ln.a + ln.r for ln in lanes)
        ok = _decompress_ok(enc, 2 * len(lanes))
        good, gmap = [], []
        for j, (ln, i) in enumerate(zip(lanes, idx_map)):
            if ok[2 * j] and ok[2 * j + 1]:
                good.append(ln)
                gmap.append(i)
        lanes, idx_map = good, gmap
        if not lanes:
            return
        if _check_lanes(lanes):
            for i in idx_map:
                out[i] = True
            return
    _attribute(lanes, out, idx_map)


def _attribute(lanes, out, idx_map) -> None:
    """Binary-split attribution of a failing batch."""
    if len(lanes) == 1:
        out[idx_map[0]] = _check_lanes(lanes)
        return
    if _check_lanes(lanes):
        for i in idx_map:
            out[i] = True
        return
    mid = len(lanes) // 2
    _attribute(lanes[:mid], out, idx_map[:mid])
    _attribute(lanes[mid:], out, idx_map[mid:])


def verify_quads(quads) -> list[bool]:
    """Per-lane verdicts of precomputed (A_enc, R_enc, s, k) quads, None
    for a lane the caller rejected (False): one RLC MSM over the rest,
    attributed by binary splitting when it fails. The sr25519 host tier:
    merlin challenges (:func:`sr_challenge_batch`) on ristretto points
    compressed as Edwards encodings, the cofactored equation deciding
    ristretto equality (the reference's crypto/sr25519/batch.go:48-61
    feeds the same verifier core as its ed25519 batch)."""
    _load()
    n = len(quads)
    out = [False] * n
    lanes, idx_map = [], []
    for i, q in enumerate(quads):
        if q is None:
            continue
        a_enc, r_enc, s, k = q
        if len(a_enc) != 32 or len(r_enc) != 32:
            raise ValueError(f"quad {i}: A and R must be 32-byte encodings")
        z = 0
        while z == 0:  # z == 0 voids the RLC: redraw (p = 2^-128)
            z = int.from_bytes(secrets.token_bytes(16), "little")
        lanes.append(_Lane(bytes(a_enc), bytes(r_enc), s, k, z))
        idx_map.append(i)
    _verdict_lanes(lanes, out, idx_map)
    return out


def verify_many(pubkeys, msgs, sigs) -> list[bool]:
    """Per-lane ZIP-215 verdicts of a batch: one fused native call (the
    challenges, the coefficients mod L and the MSM) when every lane is
    valid; otherwise the failing batch is attributed lane by lane. A lane
    of the wrong length or with S >= L is False."""
    lib = _load()
    n = len(pubkeys)
    out = [False] * n
    well = []  # (index, pubkey, sig, msg) of the well-formed lanes
    for i in range(n):
        p, m, s = bytes(pubkeys[i]), bytes(msgs[i]), bytes(sigs[i])
        if len(p) != 32 or len(s) != 64:
            continue
        if int.from_bytes(s[32:], "little") >= L:
            continue  # S must be canonical even under ZIP-215
        well.append((i, p, s, m))
    if not well:
        return out
    zs = bytearray(secrets.token_bytes(16 * len(well)))
    zero16 = bytes(16)
    for j in range(len(well)):  # z == 0 voids the RLC: redraw (p = 2^-128)
        while zs[16 * j : 16 * j + 16] == zero16:
            zs[16 * j : 16 * j + 16] = secrets.token_bytes(16)
    recs = b"".join(p + s for _i, p, s, _m in well)
    msgs_blob = b"".join(m for *_x, m in well)
    offs = np.zeros(len(well) + 1, np.uint64)
    np.cumsum([len(m) for *_x, m in well], out=offs[1:])
    res = lib.edb_verify_batch(
        recs, msgs_blob, offs.ctypes.data, bytes(zs), len(well)
    )
    if res == 1:
        for i, *_x in well:
            out[i] = True
        return out
    # A failing batch: rebuild the lanes in Python with the SAME
    # coefficients (never revealed, so still sound) and attribute.
    lanes, idx_map = [], []
    for j, (i, p, s, m) in enumerate(well):
        k = ref.challenge_scalar(s[:32], p, m)
        z = int.from_bytes(zs[16 * j : 16 * j + 16], "little")
        lanes.append(
            _Lane(p, s[:32], int.from_bytes(s[32:], "little"), k, z)
        )
        idx_map.append(i)
    _verdict_lanes(lanes, out, idx_map, res=res)
    return out
