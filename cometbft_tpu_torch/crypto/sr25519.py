"""sr25519: Schnorr signatures over ristretto255 with merlin transcripts.

Reference surface: crypto/sr25519/{privkey,pubkey,batch}.go (backed by
curve25519-voi's schnorrkel). The stack:

* keccak-f[1600], through the native engine (crypto/host_batch,
  native/edbatch.cpp); :func:`keccak_f1600_plain` is the Python loop the
  tests hold it against;
* STROBE-128 as merlin specializes it (strobe.rs: AD, meta-AD, PRF, KEY);
* merlin transcripts (dom-sep framing, LE32 length prefixes), pinned to
  merlin's published protocol vector by the tests;
* ristretto255 encode and decode (RFC 9496) over the ed25519 oracle's
  integer arithmetic, pinned to the RFC's generator multiples;
* schnorrkel signing and verification: ``SigningContext`` transcripts,
  ``Schnorr-sig`` framing, 64-byte signatures with the schnorrkel v1
  marker bit (s[31] |= 0x80).

Key expansion is ExpansionMode::Uniform (the first 32 SHA-512 bytes mod
L); the nonce comes deterministically from the transcript and the nonce
seed, so a signature is a pure function of key and message. Verification
checks s*B - k*A == R, which runs on the same verifier as ed25519: the
cofactored equation [8](sB - kA - R) == O decides ristretto equality
exactly, since decoded ristretto points lie in 2E, whose torsion E[4] is
what the ristretto quotient removes.

Batches go through the native engine: the merlin challenges
(:func:`challenge_scalars_batch`) and the ristretto -> Edwards conversion
(:func:`verification_encs_batch`) run in C, then either the host RLC
batch (host_batch.verify_quads) or the device kernels (crypto/batch,
ops/verify.verify_prepacked) decide. An engine that does not build
raises; the pure-Python :func:`_challenge_py`, :func:`ristretto_decode`
and :func:`keccak_f1600_plain` are the plain versions the tests hold the
native calls against, never a path taken when those fail.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import ed25519_ref as ref
from . import host_batch, tmhash
from .keys import SR25519_KEY_TYPE, Address

PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # mini secret
SIGNATURE_SIZE = 64

P = ref.P
L = ref.L
D = ref.D
SQRT_M1 = pow(2, (P - 1) // 4, P)

SIGNING_CTX = b"substrate"  # the conventional substrate signing context

# ---------------------------------------------------------------------------
# keccak-f[1600]
# ---------------------------------------------------------------------------

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_M64 = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state, in the native engine."""
    host_batch.keccak_f1600_inplace(state)


def keccak_f1600_plain(state: bytearray) -> None:
    """:func:`keccak_f1600` as a Python loop: the plain version the tests
    hold the engine's permutation against."""
    a = [
        int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)
    ]
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    a[x + 5 * y], _ROTC[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]
                ) & _M64
        # iota
        a[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = a[i].to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (merlin's subset, strobe.rs)
# ---------------------------------------------------------------------------

_STROBE_R = 166
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = 1, 2, 4, 8, 16, 32


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        init = (
            bytes([1, _STROBE_R + 2, 1, 0, 1, 96]) + b"STROBEv1.0.2"
        )
        self.state[: len(init)] = init
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("STROBE: continued op changed its flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        other = object.__new__(Strobe128)
        other.state = bytearray(self.state)
        other.pos = self.pos
        other.pos_begin = self.pos_begin
        other.cur_flags = self.cur_flags
        return other


# ---------------------------------------------------------------------------
# merlin transcripts
# ---------------------------------------------------------------------------


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label + _le32(len(message)), False)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + _le32(n), False)
        return self.strobe.prf(n, False)

    def challenge_scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge_bytes(label, 64), "little") % L

    def witness_scalar(self, label: bytes, nonce_seeds: list[bytes]) -> int:
        """Deterministic witness: fork the transcript and rekey it with the
        nonce seeds (merlin's transcript RNG with no external
        entropy)."""
        fork = self.strobe.clone()
        for seed in nonce_seeds:
            fork.meta_ad(label + _le32(len(seed)), False)
            fork.key(seed, False)
        return int.from_bytes(fork.prf(64, False), "little") % L


# ---------------------------------------------------------------------------
# ristretto255 (RFC 9496) over the ed25519 oracle's integer arithmetic
# ---------------------------------------------------------------------------


def _is_neg(x: int) -> bool:
    return x % P % 2 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_neg(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v) or sqrt(i*u/v)), RFC 9496 section 4.2."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u % P
    flipped = check == (-u) % P
    flipped_i = check == (-u) % P * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


_INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)[1]


def ristretto_decode(data: bytes):
    """32 bytes -> Edwards extended point, or None if invalid. The plain
    version of the engine's decode (host_batch.ristretto_to_edwards_batch,
    with ed25519_ref.compress)."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_neg(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_neg(t) or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_encode(pt) -> bytes:
    """Edwards extended point -> canonical 32-byte encoding (RFC 9496)."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) % P * ((z0 - y0) % P) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_neg(t0 * z_inv % P):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * _INVSQRT_A_MINUS_D % P
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_neg(x * z_inv % P):
        y = (-y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# schnorrkel
# ---------------------------------------------------------------------------


def _expand_uniform(mini: bytes) -> tuple[int, bytes]:
    """ExpansionMode::Uniform: scalar = SHA512(mini)[:32] mod L, nonce seed
    = SHA512(mini)[32:]."""
    h = hashlib.sha512(mini).digest()
    return int.from_bytes(h[:32], "little") % L, h[32:]


def _base_mult(scalar: int):
    """[s]B through the engine's constant-time ladder: signing scalars are
    secrets."""
    return host_batch.scalar_base_mult(scalar)


def public_from_mini(mini: bytes) -> bytes:
    scalar, _ = _expand_uniform(mini)
    return ristretto_encode(_base_mult(scalar))


def _signing_transcript(context: bytes, msg: bytes) -> Transcript:
    """schnorrkel's SigningContext: Transcript(b"SigningContext") +
    append(b"", ctx) + append(b"sign-bytes", msg)."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", context)
    t.append_message(b"sign-bytes", msg)
    return t


def sign(mini: bytes, msg: bytes, context: bytes = SIGNING_CTX) -> bytes:
    scalar, nonce_seed = _expand_uniform(mini)
    pub = ristretto_encode(_base_mult(scalar))
    t = _signing_transcript(context, msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    r = t.witness_scalar(b"signing", [nonce_seed])
    r_enc = ristretto_encode(_base_mult(r))
    t.append_message(b"sign:R", r_enc)
    k = t.challenge_scalar(b"sign:c")
    s = (k * scalar + r) % L
    s_bytes = bytearray(s.to_bytes(32, "little"))
    s_bytes[31] |= 0x80  # schnorrkel v1 marker
    return r_enc + bytes(s_bytes)


# ---------------------------------------------------------------------------
# verification challenges, batched in the native engine
# ---------------------------------------------------------------------------

# Serialized STROBE states of Transcript("SigningContext") +
# append_message(b"", context): a pure function of the signing context,
# shared by every challenge under it. Bounded: contexts are a small static
# set (conventionally just b"substrate").
_CTX_PREFIX_CACHE: dict[bytes, bytes] = {}


def _context_prefix(context: bytes) -> bytes:
    """The 203-byte serialized STROBE state (sponge || pos || pos_begin ||
    cur_flags) of the per-context transcript prefix, which
    native/edbatch.cpp's edb_sr_challenge_batch starts every lane from."""
    st = _CTX_PREFIX_CACHE.get(context)
    if st is None:
        t = Transcript(b"SigningContext")
        t.append_message(b"", context)
        s = t.strobe
        st = bytes(s.state) + bytes([s.pos, s.pos_begin, s.cur_flags])
        if len(_CTX_PREFIX_CACHE) < 64:
            _CTX_PREFIX_CACHE[context] = st
    return st


def _challenge_py(context: bytes, msg: bytes, pubkey: bytes,
                  r_enc: bytes) -> int:
    """One transcript challenge in Python: the plain version of the
    engine's batch (:func:`challenge_scalars_batch`), for the tests."""
    t = _signing_transcript(context, msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pubkey)
    t.append_message(b"sign:R", r_enc)
    return t.challenge_scalar(b"sign:c")


def challenge_scalars_batch(
    pubkeys, msgs, sigs, context: bytes = SIGNING_CTX
) -> list[int]:
    """k_i of each (pubkey, msg, R = sig[:32]) lane in one native call:
    the whole STROBE absorb / permute / squeeze sequence runs in C from the
    cached per-context prefix state (the reference's
    crypto/sr25519/batch.go:14-46 computes these per entry)."""
    n = len(pubkeys)
    recs = b"".join(bytes(p) + bytes(s[:32]) for p, s in zip(pubkeys, sigs))
    offs = [0]
    for m in msgs:
        offs.append(offs[-1] + len(m))
    raw = host_batch.sr_challenge_batch(
        _context_prefix(context), recs, b"".join(bytes(m) for m in msgs),
        offs, n
    )
    return [
        int.from_bytes(raw[32 * i : 32 * i + 32], "little")
        for i in range(n)
    ]


def _admit(pubkey: bytes, sig: bytes):
    """Structural admission shared by every verify path: lengths, the
    schnorrkel v1 marker bit, s < L. Returns s with the marker masked off,
    or None if malformed."""
    if len(sig) != SIGNATURE_SIZE or len(pubkey) != PUBKEY_SIZE:
        return None
    if not (sig[63] & 0x80):
        return None  # not a schnorrkel v1 signature
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return None
    return s


def verification_encs_batch(
    pubkeys, msgs, sigs, context: bytes = SIGNING_CTX
) -> list:
    """Per-lane (A_edwards_enc, R_edwards_enc, s, k), None for malformed
    lanes: the ristretto decodes and the challenges both batched in the
    native engine. Both batch consumers, the host MSM and the device
    kernels, take compressed Edwards points, so no Python bigint touches a
    point here."""
    n = len(pubkeys)
    parts: list = [None] * n
    # structural admission (cheap Python): lengths, marker bit, s < L
    svals = [_admit(pubkeys[i], sigs[i]) for i in range(n)]
    cand = [i for i in range(n) if svals[i] is not None]
    if not cand:
        return parts
    enc_rows, ok = host_batch.ristretto_to_edwards_batch(
        b"".join(bytes(pubkeys[i]) + bytes(sigs[i][:32]) for i in cand),
        2 * len(cand),
    )
    live = [i for j, i in enumerate(cand) if ok[2 * j] and ok[2 * j + 1]]
    if not live:
        return parts
    encs = {
        i: (enc_rows[64 * j : 64 * j + 32],
            enc_rows[64 * j + 32 : 64 * j + 64])
        for j, i in enumerate(cand)
    }
    ks = challenge_scalars_batch(
        [pubkeys[i] for i in live],
        [msgs[i] for i in live],
        [sigs[i] for i in live],
        context,
    )
    for j, i in enumerate(live):
        a_enc, r_enc = encs[i]
        parts[i] = (a_enc, r_enc, svals[i], ks[j])
    return parts


def verify(
    pubkey: bytes, msg: bytes, sig: bytes, context: bytes = SIGNING_CTX
) -> bool:
    """One signature on the host: s*B - k*A == R in ristretto, as one
    three-point cofactored MSM in the native engine (host_batch.
    verify_quads)."""
    quad = verification_encs_batch([pubkey], [msg], [sig], context)[0]
    if quad is None:
        return False
    return host_batch.verify_quads([quad])[0]


# ---------------------------------------------------------------------------
# key types (crypto.PubKey / PrivKey contracts)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Sr25519PubKey:
    data: bytes

    def __post_init__(self) -> None:
        if len(self.data) != PUBKEY_SIZE:
            raise ValueError("sr25519 pubkey must be 32 bytes")

    @property
    def type(self) -> str:
        return SR25519_KEY_TYPE

    def address(self) -> bytes:
        return Address(tmhash.sum_truncated(self.data))

    def bytes(self) -> bytes:
        return self.data

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        return verify(self.data, msg, sig)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Sr25519PubKey) and self.data == other.data

    def __hash__(self) -> int:
        return hash((SR25519_KEY_TYPE, self.data))


@dataclass(frozen=True, slots=True)
class Sr25519PrivKey:
    data: bytes  # mini secret

    def __post_init__(self) -> None:
        if len(self.data) != PRIVKEY_SIZE:
            raise ValueError("sr25519 privkey must be a 32-byte mini secret")

    @classmethod
    def from_seed(cls, seed: bytes) -> "Sr25519PrivKey":
        return cls(seed)

    @property
    def type(self) -> str:
        return SR25519_KEY_TYPE

    def bytes(self) -> bytes:
        return self.data

    def sign(self, msg: bytes) -> bytes:
        return sign(self.data, msg)

    def pub_key(self) -> Sr25519PubKey:
        return Sr25519PubKey(public_from_mini(self.data))
