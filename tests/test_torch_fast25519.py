"""The port's host single verify and sign (crypto/fast25519.py) vs the JAX
package's, on the CPU.

verify_one must give the reference's fast25519.verify_one verdicts (and
the corpus's) on the ZIP-215 conformance corpus and on seeded lanes:
once with the ``cryptography`` wheel's OpenSSL tier (installed here), and
once with it switched off as on a machine without the wheel (the native
engine, then the oracle on a reject). sign_one and pubkey_from_seed must
give the oracle's bytes either way, and the key types must route through
them. An error inside a tier that runs propagates.
"""

import random

import pytest

from cometbft_tpu.crypto import fast25519 as jfast
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import fast25519 as tfast
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.crypto import keys as tkeys
from test_zip215_conformance import build_corpus


def _lanes(n=12, seed=21):
    """n seeded lanes, every third one tampered: (pk, msg, sig) each."""
    rnd = random.Random(seed)
    out = []
    for i in range(n):
        s = rnd.randbytes(32)
        m = rnd.randbytes(rnd.randrange(0, 200))
        sig = ref.sign(s, m)
        if i % 3 == 2:
            sig = sig[:5] + bytes([sig[5] ^ 0x40]) + sig[6:]
        out.append((ref.pubkey_from_seed(s), m, sig))
    out.append((out[0][0][:31], out[0][1], out[0][2]))  # short key
    out.append((out[0][0], out[0][1], out[0][2][:63]))  # short signature
    return out


@pytest.fixture(params=["openssl", "native"])
def tier(request, monkeypatch):
    """The wheel's tier on, or off as on a machine without the wheel (its
    key parser then must not be reached)."""
    if request.param == "native":
        monkeypatch.setattr(tfast, "HAVE_OPENSSL", False)

        def no_wheel(pubkey):
            raise AssertionError("the OpenSSL tier ran without the wheel")
        monkeypatch.setattr(tfast, "_loaded_key", no_wheel)
    elif not tfast.HAVE_OPENSSL:
        pytest.skip("the cryptography wheel is not installed")
    return request.param


def test_the_wheel_is_probed_at_import():
    try:
        import cryptography  # noqa: F401
    except ImportError:
        assert tfast.HAVE_OPENSSL is False and tfast.tier() == "native"
    else:
        assert tfast.HAVE_OPENSSL is True and tfast.tier() == "openssl"


def test_verify_one_on_the_zip215_corpus(tier):
    corpus = build_corpus()
    assert tfast.tier() == tier
    for name, pk, msg, sig, expected in corpus:
        got = tfast.verify_one(pk, msg, sig)
        assert got == jfast.verify_one(pk, msg, sig) == expected, name


def test_verify_one_on_seeded_lanes(tier):
    lanes = _lanes()
    got = [tfast.verify_one(*lane) for lane in lanes]
    assert got == [jfast.verify_one(*lane) for lane in lanes]
    assert got == [ref.verify(*lane) for lane in lanes]
    assert got.count(False) == 6  # four tampered, two malformed
    assert tfast.verify_many(*zip(*lanes)) == got


def test_sign_and_derive_equal_the_oracle(tier):
    rnd = random.Random(5)
    for _ in range(4):
        seed = rnd.randbytes(32)
        msg = rnd.randbytes(rnd.randrange(0, 100))
        assert tfast.pubkey_from_seed(seed) == ref.pubkey_from_seed(seed)
        assert tfast.sign_one(seed, msg) == ref.sign(seed, msg)
        assert tfast.sign_one(seed, msg) == jfast.sign_one(seed, msg)


def test_key_types_route_through_fast25519(monkeypatch):
    calls = []
    for name in ("verify_one", "sign_one", "pubkey_from_seed"):
        def spy(*a, _real=getattr(tfast, name), _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(tfast, name, spy)
    priv = tkeys.Ed25519PrivKey.from_seed(b"\x07" * 32)
    sig = priv.sign(b"msg")
    assert priv.pub_key().verify_signature(b"msg", sig)
    assert not priv.pub_key().verify_signature(b"other", sig)
    assert calls == ["pubkey_from_seed", "sign_one", "verify_one",
                     "verify_one"]
    assert sig == ref.sign(b"\x07" * 32, b"msg")


def test_a_tier_that_raises_propagates(tier, monkeypatch):
    """A reject of the first tier goes to the native engine; when that
    raises (an engine that does not build raises NativeBuildError), the
    error reaches the caller: no tier swallows it."""
    def broken(*a):
        raise RuntimeError("native engine failed")
    monkeypatch.setattr(thost, "verify_many", broken)
    pk, msg, sig = _lanes(3)[2]  # tampered: every tier before it rejects
    with pytest.raises(RuntimeError, match="native engine failed"):
        tfast.verify_one(pk, msg, sig)
