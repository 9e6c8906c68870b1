"""The port's sr25519 and secp256k1 keys vs the JAX package, on the CPU.

cometbft_tpu_torch.crypto.sr25519 is held against cometbft_tpu.crypto.
sr25519 with exact equality: merlin's published protocol vector, RFC 9496's
generator multiples, the 203-byte STROBE prefix the native challenge batch
starts from, the native keccak, challenges and ristretto -> Edwards
conversion against the port's plain versions and the reference's,
deterministic signatures byte for byte, verification both ways, and the
edge lanes (no marker bit, s >= L, non-canonical and non-square ristretto
encodings, wrong lengths) lane for lane. cometbft_tpu_torch.crypto.
secp256k1 does its ECDSA in Python integers. It is pinned, with or without
the ``cryptography`` wheel, to published known answers (the multiples of G,
RFC 6979 signatures, RIPEMD-160's vectors) and to properties: n*G is the
point at infinity, any flipped bit of r, s, the key or the message fails,
high S and malformed keys and signatures verify False. Where the wheel is
installed it also verifies the reference's signatures (OpenSSL) and the
reference verifies its, and keys, addresses and its RIPEMD-160 equal the
reference's and hashlib's; those comparisons skip without the wheel.
"""

import hashlib
import random

import numpy as np
import pytest

from cometbft_tpu.crypto import host_batch as jhost
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.crypto import sr25519 as tsr

from helpers import HAVE_CRYPTOGRAPHY

needs_wheel = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="the reference's secp256k1 keys need the cryptography wheel",
)

CONTEXTS = (tsr.SIGNING_CTX, b"", b"another-context")
# message lengths on both sides of the STROBE rate (166) and twice it
MSG_LENS = (0, 1, 37, 150, 165, 166, 167, 331, 332, 333, 1000)


def _mini(i: int) -> bytes:
    return hashlib.sha256(b"sr25519 test key %d" % i).digest()


def _lanes(n: int, context=tsr.SIGNING_CTX):
    """(pubkeys, msgs, sigs) of n seeded keys, signed by the port."""
    minis = [_mini(i) for i in range(n)]
    msgs = [bytes(random.Random(i).randbytes(MSG_LENS[i % len(MSG_LENS)]))
            for i in range(n)]
    return ([tsr.public_from_mini(m) for m in minis], msgs,
            [tsr.sign(m, msg, context) for m, msg in zip(minis, msgs)])


# -- merlin, STROBE, keccak ---------------------------------------------------


def test_merlin_published_vector_and_reference_transcripts():
    for mod in (tsr, jsr):
        t = mod.Transcript(b"test protocol")
        t.append_message(b"some label", b"some data")
        assert t.challenge_bytes(b"challenge", 32).hex() == (
            "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
        )
    for n in MSG_LENS:
        data = bytes(range(256)) * 4
        tt, jt = tsr.Transcript(b"p"), jsr.Transcript(b"p")
        for t in (tt, jt):
            t.append_message(b"a", data[:n])
            t.append_message(b"u", n.to_bytes(8, "little"))
        assert tt.challenge_bytes(b"c", 64) == jt.challenge_bytes(b"c", 64)
        assert (tt.witness_scalar(b"w", [data[:n]])
                == jt.witness_scalar(b"w", [data[:n]]))


@pytest.mark.parametrize("context", CONTEXTS)
def test_context_prefix_is_the_references_strobe_state(context):
    """The 203 bytes the native challenge batch starts every lane from:
    one byte off and every sr25519 lane verifies False."""
    got = tsr._context_prefix(context)
    assert len(got) == 203
    assert got == jsr._context_prefix(context)


def test_native_keccak_equals_plain_and_reference():
    rng = random.Random(7)
    for _ in range(6):
        start = bytes(rng.randbytes(200))
        native, plain, theirs = (bytearray(start) for _ in range(3))
        thost.keccak_f1600_inplace(native)
        tsr.keccak_f1600_plain(plain)
        jsr.keccak_f1600(theirs)
        assert bytes(native) == bytes(plain) == bytes(theirs)
    with pytest.raises(ValueError, match="200-byte"):
        thost.keccak_f1600_inplace(bytearray(199))


@pytest.mark.parametrize("context", CONTEXTS)
def test_native_challenges_equal_plain_and_reference(context):
    pks, msgs, sigs = _lanes(len(MSG_LENS), context)
    got = tsr.challenge_scalars_batch(pks, msgs, sigs, context)
    assert got == [tsr._challenge_py(context, m, p, s[:32])
                   for p, m, s in zip(pks, msgs, sigs)]
    assert got == jsr.challenge_scalars_batch(pks, msgs, sigs, context)


def test_challenge_batch_rejects_short_buffers():
    state = tsr._context_prefix(tsr.SIGNING_CTX)
    with pytest.raises(ValueError, match="203"):
        thost.sr_challenge_batch(state[:202], bytes(64), b"", [0, 0], 1)
    with pytest.raises(ValueError, match="recs"):
        thost.sr_challenge_batch(state, bytes(63), b"", [0, 0], 1)
    with pytest.raises(ValueError, match="offs"):
        thost.sr_challenge_batch(state, bytes(64), b"ab", [0, 3], 1)
    assert thost.sr_challenge_batch(state, b"", b"", [0], 0) == b""


# -- ristretto255 --------------------------------------------------------------

RFC9496_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    "e882b131016b52c1d3337080187cf768423efccbb517bb495ab812c4160ff44e",
]


def _non_square_encodings(k: int):
    """Canonical, even s whose decode fails on the square root."""
    out, s = [], 2
    while len(out) < k:
        enc = s.to_bytes(32, "little")
        if jsr.ristretto_decode(enc) is None:
            out.append(enc)
        s += 2
    return out


def _rejected_encodings():
    p = tsr.P
    return [
        (1).to_bytes(32, "little"),  # odd s: negative
        b"\xff" * 32,  # s >= p
        p.to_bytes(32, "little"),  # s = p, non-canonical zero
        (p + 2).to_bytes(32, "little"),  # s = p + 2, non-canonical 2
        *_non_square_encodings(3),
    ]


def test_rfc9496_generator_multiples():
    pt = ref.IDENTITY
    for i, want in enumerate(RFC9496_MULTIPLES):
        assert tsr.ristretto_encode(pt).hex() == want, i
        dec = tsr.ristretto_decode(bytes.fromhex(want))
        assert dec == jsr.ristretto_decode(bytes.fromhex(want))
        assert tsr.ristretto_encode(dec).hex() == want  # round trip
        pt = ref.point_add(pt, ref.BASE)


def test_native_ristretto_to_edwards_equals_plain_and_reference():
    encs = [tsr.ristretto_encode(ref.scalar_mult(k, ref.BASE))
            for k in (1, 2, 7, 12345, ref.L - 1)]
    encs += [tsr.public_from_mini(_mini(i)) for i in range(6)]
    rejected = _rejected_encodings()
    encs += rejected
    got_rows, got_ok = thost.ristretto_to_edwards_batch(b"".join(encs),
                                                        len(encs))
    their_rows, their_ok = jhost.ristretto_to_edwards_batch(b"".join(encs),
                                                            len(encs))
    assert got_rows == their_rows
    assert np.array_equal(got_ok, their_ok)
    assert got_ok.tolist() == [True] * (len(encs) - len(rejected)) + [
        False] * len(rejected)
    for i, enc in enumerate(encs):
        pt = tsr.ristretto_decode(enc)
        assert (pt is not None) == bool(got_ok[i]), i
        if pt is not None:
            assert got_rows[32 * i : 32 * i + 32] == ref.compress(pt), i
    with pytest.raises(ValueError, match="32"):
        thost.ristretto_to_edwards_batch(bytes(33), 1)


def test_native_base_mult_equals_oracle():
    rng = random.Random(99)
    for s in [0, 1, 2, ref.L - 1, ref.L, ref.L + 5] + [
            rng.randrange(ref.L) for _ in range(8)]:
        pt = thost.scalar_base_mult(s)
        assert ref.point_equal(pt, ref.scalar_mult(s % ref.L, ref.BASE)), s
        assert pt == jhost.scalar_base_mult(s)


# -- schnorrkel ---------------------------------------------------------------


@pytest.mark.parametrize("context", CONTEXTS)
def test_signatures_are_the_references_byte_for_byte(context):
    for i, n in enumerate(MSG_LENS):
        mini, msg = _mini(100 + i), bytes(range(n % 256)) * (n // 256 + 1)
        assert tsr.public_from_mini(mini) == jsr.public_from_mini(mini)
        sig = tsr.sign(mini, msg, context)
        assert sig == jsr.sign(mini, msg, context)
        assert sig[63] & 0x80  # schnorrkel v1 marker
    priv = tsr.Sr25519PrivKey.from_seed(_mini(7))
    theirs = jsr.Sr25519PrivKey.from_seed(_mini(7))
    assert priv.pub_key().data == theirs.pub_key().data
    assert priv.pub_key().address() == theirs.pub_key().address()
    assert priv.sign(b"vote") == theirs.sign(b"vote")


def test_cross_verification_both_ways():
    for i in range(6):
        mini, msg = _mini(200 + i), b"cross %d" % i
        pub = tsr.public_from_mini(mini)
        ours, theirs = tsr.sign(mini, msg), jsr.sign(mini, msg)
        for sig in (ours, theirs):
            assert tsr.verify(pub, msg, sig) and jsr.verify(pub, msg, sig)
            assert not tsr.verify(pub, msg + b"!", sig)
            assert not jsr.verify(pub, msg + b"!", sig)
        other = tsr.public_from_mini(_mini(300 + i))
        assert not tsr.verify(other, msg, ours)
        assert tsr.Sr25519PubKey(pub).verify_signature(msg, ours)


def _edge_lanes():
    """(name, pubkey, msg, sig): valid lanes between the edge lanes."""
    pks, msgs, sigs = _lanes(4)
    good, pk, msg = sigs[0], pks[0], msgs[0]
    s_int = int.from_bytes(good[32:63] + bytes([good[63] & 0x7F]), "little")
    non_square = _non_square_encodings(1)[0]
    lanes = [("valid", pk, msg, good)]
    lanes.append(("no marker bit", pk, msg, good[:63] + bytes([good[63]
                                                              & 0x7F])))
    for name, s in (("s = L", tsr.L), ("s = s + L", s_int + tsr.L)):
        sb = bytearray(s.to_bytes(32, "little"))
        sb[31] |= 0x80
        lanes.append((name, pk, msg, good[:32] + bytes(sb)))
    lanes.append(("R non-canonical (s >= p)", pk, msg,
                  (tsr.P + 2).to_bytes(32, "little") + good[32:]))
    lanes.append(("R negative (odd s)", pk, msg,
                  (1).to_bytes(32, "little") + good[32:]))
    lanes.append(("R non-square", pk, msg, non_square + good[32:]))
    lanes.append(("A non-square", non_square, msg, good))
    lanes.append(("A non-canonical", tsr.P.to_bytes(32, "little"), msg, good))
    lanes.append(("valid 2", pks[1], msgs[1], sigs[1]))
    lanes.append(("truncated signature", pk, msg, good[:40]))
    lanes.append(("short pubkey", pk[:31], msg, good))
    lanes.append(("wrong message", pks[2], msgs[2] + b"!", sigs[2]))
    lanes.append(("flipped s bit", pks[3], msgs[3],
                  sigs[3][:40] + bytes([sigs[3][40] ^ 4]) + sigs[3][41:]))
    return lanes


def test_edge_lanes_lane_for_lane():
    lanes = _edge_lanes()
    pks, msgs, sigs = ([ln[i] for ln in lanes] for i in (1, 2, 3))
    ours = tsr.verification_encs_batch(pks, msgs, sigs)
    theirs = jsr.verification_encs_batch(pks, msgs, sigs)
    assert ours == theirs
    rejected = [ln[0] for ln, q in zip(lanes, ours) if q is None]
    assert rejected == [
        "no marker bit", "s = L", "s = s + L", "R non-canonical (s >= p)",
        "R negative (odd s)", "R non-square", "A non-square",
        "A non-canonical", "truncated signature", "short pubkey"]
    # the plain version: admission, then the Python ristretto decode
    for (name, pk, msg, sig), quad in zip(lanes, ours):
        s = tsr._admit(pk, sig)
        pts = [tsr.ristretto_decode(e) for e in (pk, sig[:32])]
        if s is None or None in pts:
            assert quad is None, name
            continue
        assert quad[:3] == (ref.compress(pts[0]), ref.compress(pts[1]),
                            s), name
        assert quad[3] == tsr._challenge_py(tsr.SIGNING_CTX, msg, pk,
                                            sig[:32]), name
    want = [ln[0] in ("valid", "valid 2") for ln in lanes]
    assert thost.verify_quads(ours) == jhost.verify_quads(theirs) == want
    assert [tsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)] == want
    assert [jsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)] == want


def test_registry_and_key_types():
    assert set(tkeys.PUBKEY_TYPES) == {"ed25519", "sr25519", "secp256k1"}
    assert set(tkeys.PUBKEY_TYPES) == set(jkeys.PUBKEY_TYPES)
    sv = tsr.Sr25519PrivKey.from_seed(b"\x06" * 32)
    assert tkeys.pubkey_from_type_and_bytes("sr25519",
                                            sv.pub_key().data) == sv.pub_key()
    cv = tsecp.Secp256k1PrivKey.from_seed(b"\x05" * 32)
    assert tkeys.pubkey_from_type_and_bytes(
        "secp256k1", cv.pub_key().data) == cv.pub_key()
    with pytest.raises(ValueError, match="unknown pubkey type"):
        tkeys.pubkey_from_type_and_bytes("bls12381", bytes(48))
    with pytest.raises(ValueError):
        tsr.Sr25519PubKey(bytes(31))
    with pytest.raises(ValueError):
        tsecp.Secp256k1PubKey(bytes(32))


# -- secp256k1 ----------------------------------------------------------------


# RIPEMD-160's published test vectors (Dobbertin, Bosselaers and Preneel,
# "RIPEMD-160: A Strengthened Version of RIPEMD", appendix B)
RIPEMD160_VECTORS = {
    b"": "9c1185a5c5e9fc54612808977ee8f548b2258d31",
    b"a": "0bdc9d2d256b3ee9daae347be6f4dc835a467ffe",
    b"abc": "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc",
    b"message digest": "5d0689ef49d2fae572b881b123a85ffa21595f36",
    b"abcdefghijklmnopqrstuvwxyz":
        "f71c27109c692c1b56bbdceb5b9d2865b3708dbc",
    b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq":
        "12a053384a9c0c88e405a06c27dcf49ada62eb2b",
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789":
        "b0e20b6e3116640286ed3a87a5713079b21f5189",
    b"1234567890" * 8: "9b752e45573d4b39f4dbd3323cab82bf63326bfb",
}


def test_ripemd160_plain_published_vectors():
    for data, want in RIPEMD160_VECTORS.items():
        assert tsecp.ripemd160_plain(data).hex() == want, data
        assert tsecp.ripemd160(data).hex() == want, data


def test_ripemd160_plain_equals_hashlib():
    if not tsecp.HASHLIB_RIPEMD160:
        pytest.skip("this hashlib has no RIPEMD-160 to hold the plain one to")
    rng = random.Random(3)
    for n in (0, 1, 55, 56, 63, 64, 65, 119, 120, 1000):
        data = bytes(rng.randbytes(n))
        assert tsecp.ripemd160_plain(data) == hashlib.new(
            "ripemd160", data).digest(), n


# k*G for small k, (x, y) in hex: SEC 2's base point and the multiples
# listed in Chuck Batson's secp256k1 test vectors
SECP_MULTIPLES = {
    1: ("79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798",
        "483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8"),
    2: ("C6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5",
        "1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A"),
    3: ("F9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9",
        "388F7B0F632DE8140FE337E62A37F3566500A99934C2231B6CB9FD7584B8E672"),
    4: ("E493DBF1C10D80F3581E4904930B1404CC6C13900EE0758474FA94ABE8C4CD13",
        "51ED993EA0D455B75642E2098EA51448D967AE33BFBDFE40CFE97BDC47739922"),
    5: ("2F8BDE4D1A07209355B4A7250A5C5128E88B84BDDC619AB7CBA8D569B240EFE4",
        "D8AC222636E5E3D6D4DBA9DDA6C9C426F788271BAB0D6840DCA87D3AA6AC62D6"),
    10: ("A0434D9E47F3C86235477C7B1AE6AE5D3442D49B1943C2B752A68E2A47E247C7",
         "893ABA425419BC27A3B6C7E693A24C696F794C2ED877A1593CBEE53B037368D7"),
    20: ("4CE119C96E2FA357200B559B2F7DD5A5F02D5290AFF74B03F3E471B273211C97",
         "12BA26DCB10EC1625DA61FA10A844C676162948271D96967450288EE9233DC3A"),
}

# RFC 6979 deterministic ECDSA over secp256k1 with SHA-256, (d, message,
# r || s): the known-answer vectors the Bitcoin libraries share
# (bitcoinjs-lib's ecdsa fixtures, Trezor's crypto tests); all four s are
# already low
RFC6979_VECTORS = [
    (1, b"Satoshi Nakamoto",
     "934b1ea10a4b3c1757e2b0c017d0b6143ce3c9a7e6a4a49860d7a6ab210ee3d8"
     "2442ce9d2b916064108014783e923ec36b49743e2ffa1c4496f01a512aafd9e5"),
    (1, b"All those moments will be lost in time, like tears in rain. "
        b"Time to die...",
     "8600dbd41e348fe5c9465ab92d23e3db8b98b873beecd930736488696438cb6b"
     "547fe64427496db33bf66019dacbf0039c04199abb0122918601db38a72cfc21"),
    (0xF8B8AF8CE3C7CCA5E300D33939540C10D45CE001B8F252BFBC57BA0342904181,
     b"Alan Turing",
     "7063ae83e7f62bbb171798131b4a0564b956930092b33b07b395615d9ec7e15c"
     "58dfcc1e00a35e1572f366ffe34ba0fc47db1e7189759b9fb233c5b05ab388ea"),
    (0xE91671C46231F833A6406CCBEA0E3E392C76C167BAC1CB013F6F1013980455C2,
     b"There is a computer disease that anybody who works with computers "
     b"knows about. It's a very serious disease and it interferes "
     b"completely with the work. The trouble with computers is that you "
     b"'play' with them!",
     "b552edd27580141f3b2a5463048cb7cd3e047b97c9f98076c32dbdf85a68718b"
     "279fa72dd19bfae05577e06c7c0c1900c371fcd5893f7e1d56a37d30174671f6"),
]


def _on_curve(pt) -> bool:
    x, y = pt
    return (y * y - x ** 3 - 7) % tsecp._P == 0


def test_secp256k1_multiples_of_g_are_the_published_ones():
    g = tsecp._G
    for k, (x, y) in SECP_MULTIPLES.items():
        want = (int(x, 16), int(y, 16))
        assert tsecp._affine(tsecp._jmul(k, g)) == want, k
        assert _on_curve(want)
        pub = tsecp.public_key(k.to_bytes(32, "big"))
        assert pub == bytes([2 | want[1] & 1]) + want[0].to_bytes(32, "big")
        assert tsecp.decompress(pub) == want, k
    # addition agrees with doubling and with the scalar ladder
    assert tsecp._affine(tsecp._jadd(g, g)) == tsecp._affine(tsecp._jmul(2, g))
    five = tsecp._jadd(tsecp._jmul(2, g), tsecp._jmul(3, g))
    assert tsecp._affine(five) == tuple(int(v, 16) for v in SECP_MULTIPLES[5])
    # the group order: n*G is the point at infinity, (n-1)*G is -G
    n, p = tsecp._N, tsecp._P
    assert tsecp._affine(tsecp._jmul(n, g)) is None
    assert tsecp._affine(tsecp._jmul(n - 1, g)) == (tsecp._GX, p - tsecp._GY)
    assert tsecp._affine(tsecp._jadd(tsecp._jmul(n - 1, g), g)) is None
    assert tsecp._affine(tsecp._jmul(n + 1, g)) == (tsecp._GX, tsecp._GY)


@pytest.mark.parametrize("d, msg, want", RFC6979_VECTORS)
def test_secp256k1_rfc6979_vectors(d, msg, want):
    priv = d.to_bytes(32, "big")
    pub = tsecp.public_key(priv)
    assert tsecp.sign(priv, msg).hex() == want
    assert tsecp.verify(pub, msg, bytes.fromhex(want))
    key = tsecp.Secp256k1PrivKey(priv)
    assert key.sign(msg).hex() == want
    assert key.pub_key().verify_signature(msg, bytes.fromhex(want))
    assert key.pub_key().address() == tsecp.ripemd160_plain(
        hashlib.sha256(pub).digest())


def _flip_bit(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def test_secp256k1_any_flipped_bit_fails_verify():
    """Every bit of r, s, the key and the message is bound by verify."""
    d, msg, want = RFC6979_VECTORS[2]
    sig = bytes.fromhex(want)
    pub = tsecp.public_key(d.to_bytes(32, "big"))
    assert tsecp.verify(pub, msg, sig)
    for bit in range(8 * len(sig)):
        assert not tsecp.verify(pub, msg, _flip_bit(sig, bit)), bit
    for bit in range(8 * len(pub)):
        assert not tsecp.verify(_flip_bit(pub, bit), msg, sig), bit
    for bit in range(8 * len(msg)):
        assert not tsecp.verify(pub, _flip_bit(msg, bit), sig), bit


def test_secp256k1_signing_normalizes_to_low_s_and_high_s_is_rejected():
    n = tsecp._N
    d = int.from_bytes(hashlib.sha256(b"secp low s").digest(), "big") % n
    priv = d.to_bytes(32, "big")
    pub = tsecp.public_key(priv)
    normalized = 0
    for i in range(16):
        msg = b"low s %d" % i
        h = hashlib.sha256(msg).digest()
        k = next(tsecp._rfc6979_nonces(d, h))
        r = tsecp._affine(tsecp._jmul(k, tsecp._G))[0] % n
        raw_s = pow(k, -1, n) * (int.from_bytes(h, "big") + r * d) % n
        sig = tsecp.sign(priv, msg)
        s = int.from_bytes(sig[32:], "big")
        assert int.from_bytes(sig[:32], "big") == r
        assert s == min(raw_s, n - raw_s) and s <= n // 2
        normalized += raw_s > n // 2
        assert tsecp.verify(pub, msg, sig)
        # (r, n - s) satisfies the ECDSA equation too; the low-S rule
        # alone rejects it
        high = sig[:32] + (n - s).to_bytes(32, "big")
        assert not tsecp.verify(pub, msg, high)
    assert 0 < normalized < 16


def test_secp256k1_malformed_inputs_verify_false():
    n, p = tsecp._N, tsecp._P
    d, msg, want = RFC6979_VECTORS[0]
    sig = bytes.fromhex(want)
    pub = tsecp.public_key(d.to_bytes(32, "big"))
    x_off = next(x for x in range(1, 100)
                 if tsecp.decompress(b"\x02" + x.to_bytes(32, "big")) is None)
    cases = {
        "r = s = 0": (pub, bytes(64)),
        "r = 0": (pub, bytes(32) + sig[32:]),
        "s = 0": (pub, sig[:32] + bytes(32)),
        "r = n": (pub, n.to_bytes(32, "big") + sig[32:]),
        "s = n": (pub, sig[:32] + n.to_bytes(32, "big")),
        "s = n/2 + 1": (pub, sig[:32] + (n // 2 + 1).to_bytes(32, "big")),
        "short signature": (pub, sig[:63]),
        "long signature": (pub, sig + b"\x00"),
        "uncompressed prefix": (b"\x04" + pub[1:], sig),
        "zero prefix": (b"\x00" + pub[1:], sig),
        "x off the curve": (b"\x02" + x_off.to_bytes(32, "big"), sig),
        "x = p": (b"\x02" + p.to_bytes(32, "big"), sig),
        "32-byte key": (pub[1:], sig),
        "empty key": (b"", sig),
    }
    for name, (key, s) in cases.items():
        assert not tsecp.verify(key, msg, s), name
    assert tsecp.verify(pub, msg, sig)
    for bad in (0, n, n + 1):
        with pytest.raises(ValueError, match="out of range"):
            tsecp.sign(bad.to_bytes(32, "big"), msg)
        with pytest.raises(ValueError, match="out of range"):
            tsecp.public_key(bad.to_bytes(32, "big"))


@needs_wheel
def test_secp256k1_keys_and_addresses_equal_the_references():
    from cometbft_tpu.crypto import secp256k1 as jsecp

    for i in range(4):
        seed = bytes([i + 1]) * 32
        ours = tsecp.Secp256k1PrivKey.from_seed(seed)
        theirs = jsecp.Secp256k1PrivKey.from_seed(seed)
        assert ours.data == theirs.data
        assert ours.pub_key().data == theirs.pub_key().data
        assert len(ours.pub_key().data) == 33
        assert ours.pub_key().address() == theirs.pub_key().address()
        assert bytes(ours.pub_key().address()) == tsecp.ripemd160_plain(
            hashlib.sha256(ours.pub_key().data).digest())


@needs_wheel
def test_secp256k1_cross_verification_and_low_s():
    from cometbft_tpu.crypto import secp256k1 as jsecp

    n = tsecp._N
    for i in range(4):
        seed = bytes([i + 11]) * 32
        ours = tsecp.Secp256k1PrivKey.from_seed(seed)
        theirs = jsecp.Secp256k1PrivKey.from_seed(seed)
        msg = b"secp payload %d" % i
        for sig in (ours.sign(msg), theirs.sign(msg)):
            assert int.from_bytes(sig[32:], "big") <= n // 2  # low S
            assert ours.pub_key().verify_signature(msg, sig)
            assert theirs.pub_key().verify_signature(msg, sig)
            assert not ours.pub_key().verify_signature(msg + b"!", sig)
            high = sig[:32] + (n - int.from_bytes(sig[32:], "big")).to_bytes(
                32, "big")
            assert not ours.pub_key().verify_signature(msg, high)
            assert not theirs.pub_key().verify_signature(msg, high)
        assert ours.sign(msg) == ours.sign(msg)  # RFC 6979: deterministic


@needs_wheel
def test_secp256k1_malformed_inputs_verify_false_alike():
    from cometbft_tpu.crypto import secp256k1 as jsecp

    priv = tsecp.Secp256k1PrivKey.from_seed(b"\x21" * 32)
    msg = b"malformed"
    sig = priv.sign(msg)
    pub = priv.pub_key().data
    x_off = next(x for x in range(1, 100)
                 if tsecp.decompress(b"\x02" + x.to_bytes(32, "big")) is None)
    cases = [
        (pub, bytes(64)),  # r = s = 0
        (pub, sig[:63]),  # short
        (pub, tsecp._N.to_bytes(32, "big") + sig[32:]),  # r = n
        (b"\x04" + pub[1:], sig),  # not a compressed prefix
        (b"\x02" + x_off.to_bytes(32, "big"), sig),  # x off the curve
        (b"\x02" + tsecp._P.to_bytes(32, "big"), sig),  # x = p
        (pub, sig),
    ]
    for key, s in cases:
        got = tsecp.verify(key, msg, s)
        assert got == jsecp.Secp256k1PubKey(key).verify_signature(msg, s)
    assert [tsecp.verify(k, msg, s) for k, s in cases] == [False] * 6 + [True]
