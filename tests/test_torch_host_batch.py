"""The port's native host tier and packer vs the JAX package, on the CPU.

cometbft_tpu_torch/native/edbatch.cpp is the port's own copy of the
engine, built with g++ by cometbft_tpu_torch/libs/native_build.py into
build/native/. The same lanes, made from a seed, go through both
packages: ops.verify.pack_bytes (native) must give the reference's
ops.verify.pack_bytes bytes and the port's own Python loop
(pack_bytes_plain), and crypto.host_batch.verify_many the reference's
verdicts, exactly: valid lanes, wrong lengths, S >= L, the ZIP-215
classes, tampered lanes, a seeded fuzz, one lane and none. A source that
does not compile raises NativeBuildError, and nothing falls back.
"""

import os
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu.crypto import host_batch as jhost
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import host_batch as thost
from cometbft_tpu_torch.libs import native_build
from cometbft_tpu_torch.ops import verify as tverify
from test_zip215_conformance import build_corpus

ROOT = Path(__file__).resolve().parents[1]


def _lanes(n, seed=8):
    """n valid seeded lanes: (pubkeys, msgs, sigs)."""
    rnd = random.Random(seed)
    seeds = [rnd.randbytes(32) for _ in range(n)]
    msgs = [rnd.randbytes(rnd.randrange(0, 300)) for _ in range(n)]
    return ([ref.pubkey_from_seed(s) for s in seeds], msgs,
            [ref.sign(s, m) for s, m in zip(seeds, msgs)])


def _malformed():
    """Valid lanes with wrong lengths, S = L, S = 2^256 - 1 and a flipped
    bit of R and of S mixed in."""
    pks, msgs, sigs = _lanes(10, seed=9)
    pks[1] = pks[1][:31]
    sigs[2] = sigs[2][:63]
    sigs[3] = sigs[3][:32] + ref.L.to_bytes(32, "little")
    sigs[4] = sigs[4][:32] + b"\xff" * 32
    sigs[5] = bytes([sigs[5][0] ^ 4]) + sigs[5][1:]
    sigs[6] = sigs[6][:40] + bytes([sigs[6][40] ^ 1]) + sigs[6][41:]
    pks[7] = b""
    return pks, msgs, sigs


def _zip215():
    corpus = build_corpus()
    return ([v[1] for v in corpus], [v[2] for v in corpus],
            [v[3] for v in corpus], [v[4] for v in corpus])


def test_engine_is_built_by_gpp_from_the_ports_copy():
    src = ROOT / "cometbft_tpu_torch" / "native" / "edbatch.cpp"
    assert thost.SRC == src and src.exists()
    lib = thost._load()
    so = Path(lib._name)
    assert so.parent == native_build.BUILD_DIR
    assert so.stat().st_mtime >= src.stat().st_mtime
    assert thost.available()


@pytest.mark.parametrize("case", ["valid", "malformed", "zip215", "empty"])
def test_pack_bytes_equals_reference_and_plain(case):
    if case == "valid":
        pks, msgs, sigs = _lanes(33)
    elif case == "malformed":
        pks, msgs, sigs = _malformed()
    elif case == "zip215":
        pks, msgs, sigs, _ = _zip215()
    else:
        pks = msgs = sigs = []
    buf, ok = tverify.pack_bytes(pks, msgs, sigs)
    plain_buf, plain_ok = tverify.pack_bytes_plain(pks, msgs, sigs)
    j_buf, j_ok = jverify.pack_bytes(pks, msgs, sigs)
    assert buf.shape == (128, len(pks)) and buf.dtype == np.uint8
    np.testing.assert_array_equal(buf, plain_buf)
    np.testing.assert_array_equal(buf, np.asarray(j_buf))
    np.testing.assert_array_equal(ok, plain_ok)
    np.testing.assert_array_equal(ok, np.asarray(j_ok))
    if case == "malformed":
        assert ok.tolist() == [True, False, False, False, False, True,
                               True, False, True, True]
        assert not buf[:, ~ok].any()


def _tampered(n, seed):
    pks, msgs, sigs = _lanes(n, seed)
    for i in range(0, n, 7):
        sigs[i] = sigs[i][:50] + bytes([sigs[i][50] ^ 0x20]) + sigs[i][51:]
    return pks, msgs, sigs


def _fuzz(seed=11):
    """A seeded mix: valid lanes, random bytes for keys, R and S, swapped
    messages, truncated signatures."""
    rnd = random.Random(seed)
    pks, msgs, sigs = _lanes(40, seed)
    for i in range(40):
        r = rnd.random()
        if r < 0.15:
            pks[i] = rnd.randbytes(32)
        elif r < 0.3:
            sigs[i] = rnd.randbytes(32) + sigs[i][32:]
        elif r < 0.4:
            msgs[i] = msgs[(i + 1) % 40]
        elif r < 0.45:
            sigs[i] = sigs[i][: rnd.randrange(64)]
        elif r < 0.5:
            sigs[i] = sigs[i][:32] + rnd.randbytes(31) + b"\x0f"
    return pks, msgs, sigs


CASES = {
    "all_valid": lambda: _lanes(48, seed=10),
    "tampered": lambda: _tampered(30, seed=12),
    "malformed": _malformed,
    "zip215": lambda: _zip215()[:3],
    "fuzz": _fuzz,
    "one_lane": lambda: _lanes(1, seed=13),
    "one_bad_lane": lambda: (lambda p, m, s: (p, m, [bytes(64)]))(
        *_lanes(1, seed=14)),
    "empty": lambda: ([], [], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_verify_many_equals_reference(case):
    pks, msgs, sigs = CASES[case]()
    got = thost.verify_many(pks, msgs, sigs)
    assert got == jhost.verify_many(pks, msgs, sigs)
    assert got == [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    if case == "zip215":
        assert got == _zip215()[3]
    if case == "all_valid":
        assert all(got)
    if case == "tampered":
        assert [i for i, b in enumerate(got) if not b] == [0, 7, 14, 21, 28]


@pytest.fixture
def broken_engine(tmp_path, monkeypatch):
    """host_batch pointed at a copy of the engine that does not compile."""
    src = tmp_path / "edbatch.cpp"
    shutil.copy(thost.SRC, src)
    with src.open("a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(thost, "SRC", src)
    monkeypatch.setattr(thost, "_lib", None)
    return src


def test_broken_source_raises_and_nothing_falls_back(broken_engine,
                                                     monkeypatch):
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+ failed"):
        native_build.build_and_load(broken_engine)
    # the Python loop and the reference are never asked in its place
    monkeypatch.setattr(tverify, "pack_bytes_plain", None)
    pks, msgs, sigs = _lanes(3, seed=15)
    for call in (lambda: thost.verify_many(pks, msgs, sigs),
                 lambda: tverify.pack_bytes(pks, msgs, sigs),
                 thost.available):
        with pytest.raises(native_build.NativeBuildError):
            call()
    assert thost._lib is None  # no failure remembered: the next call builds
    assert not (broken_engine.parent / "build" / "_edbatch.so").exists()


def test_stale_library_is_rebuilt(tmp_path):
    """An object older than its source is compiled again (the process
    keeps the library it loaded first: the loader reuses it by path)."""
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 1; }\n')
    so = tmp_path / "out" / "_probe.so"
    assert native_build.build_and_load(src, so).probe() == 1
    old = so.stat().st_mtime
    src.write_text('extern "C" int probe() { return 2; }\n')
    os.utime(src, (old + 10, old + 10))
    native_build.build_and_load(src, so)
    assert so.stat().st_mtime > old
    assert b"probe" in so.read_bytes()


def test_concurrent_calls_from_threads_are_safe():
    """ctypes releases the GIL in every engine call: 12 threads (more than
    the cores) verify and pack at once under a short switch interval, and
    every verdict and row is the one a lone call gives."""
    import sys
    import threading

    batches = [_tampered(9 + k, seed=60 + k) for k in range(12)]
    want = [thost.verify_many(*b) for b in batches]
    packs = [tverify.pack_bytes(*b)[0] for b in batches]
    got, rows = {}, {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(k):
            for _ in range(3):
                got[k] = thost.verify_many(*batches[k])
                rows[k] = tverify.pack_bytes(*batches[k])[0]
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [got[k] for k in range(12)] == want
    for k in range(12):
        np.testing.assert_array_equal(rows[k], packs[k])
