"""The port's 8-bit fixed-base flavor (K3/K4) vs the JAX package, on the CPU.

cometbft_tpu's 8-bit flavor (COMETBFT_TPU_KERNEL=xla8|pallas8) takes [S]B
from 32 fixed-base windows of 8 bits. The port's plain versions of K3 and
K4 (ops.curve.verify_kernel8, verify_kernel8_slots, the CPU path of
ops.cuda_verify.verify_kernel8[_cached]) must give the reference's limbs
and verdicts: the 8-bit base table limb for limb, the fixed-base sum on
seeded S bytes, and the verdict bitmaps on one batch of valid lanes, the
ZIP-215 corpus, edge lanes with S next to L (little-endian bytes 0xec ...
0x10), and tampered lanes. The batch is one size throughout, so the
reference's XLA programs compile once. Every comparison is on integers or
bits: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import curve as jcurve
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu_torch.ops import cuda_verify, curve, field
from cometbft_tpu_torch.ops import verify as tverify

from test_curve import make_batch
from test_torch_verify import _edge_lanes
from test_zip215_conformance import build_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _near_l_lanes():
    """S = L - 1 under the identity key (y = 1): [S]B == R accepts; with
    R moved by one it rejects. S's top byte is 0x10, its low bytes 0xec,
    0xd3, 0xf5: the highest windows the host lets through."""
    ident = (1).to_bytes(32, "little")
    s = jref.L - 1
    r_ok = jref.compress(jref.scalar_mult(s, jref.BASE))
    r_bad = jref.compress(jref.scalar_mult(s - 1, jref.BASE))
    tail = s.to_bytes(32, "little")
    return ([ident, ident], [b"near L", b"near L"],
            [r_ok + tail, r_bad + tail])


@pytest.fixture(scope="module")
def batch():
    corpus = build_corpus()
    pks = [v[1] for v in corpus]
    msgs = [v[2] for v in corpus]
    sigs = [v[3] for v in corpus]
    for extra in (_edge_lanes(), _near_l_lanes(), make_batch(6)):
        pks, msgs, sigs = pks + extra[0], msgs + extra[1], sigs + extra[2]
    # tampered: one S byte, one R byte
    sigs[-1] = sigs[-1][:50] + bytes([sigs[-1][50] ^ 4]) + sigs[-1][51:]
    sigs[-2] = bytes([sigs[-2][0] ^ 2]) + sigs[-2][1:]
    expect = [jref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    assert expect[-8] and not expect[-7]  # the near-L lanes
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    return pks, msgs, sigs, expect, buf, host_ok


@pytest.fixture(scope="module")
def port_tables(batch):
    """The port's pubkey tables for the batch (X1's plain version; held
    limb for limb against the reference's by test_torch_verify)."""
    buf = batch[4]
    pk_bits = tverify._dev_le_bits(torch.from_numpy(buf[:32]).to(torch.int32))
    return cuda_verify.build_pubkey_tables(
        tverify._dev_y_limbs(pk_bits), pk_bits[255].contiguous()
    )


@pytest.fixture(scope="module")
def jax8(batch, port_tables):
    """The reference's 8-bit XLA functions on the batch, run once.

    Uncached: curve.verify_kernel8 inside the jitted program that the
    reference's verify_batch launches under COMETBFT_TPU_KERNEL=xla8 at
    this bucket (so verify_batch below reuses the compile), its verdicts
    read before the host checks. Cached: curve.verify_kernel8_cached on
    the same pubkey tables as the port's."""
    buf = batch[4]
    n = buf.shape[1]
    size = jverify.bucket_size(n)
    padded = np.pad(buf, [(0, 0), (0, size - n)])
    program = jverify._jitted_kernel("xla8", True, jverify._small_grid(size))
    uncached = jverify.unpack_ok_bits(np.asarray(program(padded)), size)[:n]
    b = jnp.asarray(buf).astype(jnp.int32)
    rr_bits = jverify._dev_le_bits(b[32:64])
    table, tab_ok = (np.asarray(t) for t in port_tables)
    cached = jcurve.verify_kernel8_cached(
        jnp.asarray(table), jverify._dev_y_limbs(rr_bits), rr_bits[255],
        b[64:96], jverify._dev_msb_nibbles(b[96:128]),
    )
    return {"uncached": uncached, "cached": np.asarray(cached) & tab_ok}


def test_base_table8_matches_reference_limb_for_limb():
    port = curve._base_table8_host()
    ref = jcurve._base_table8_host()
    assert port.dtype == np.int32 and port.shape == (32, 256, 3, 20)
    np.testing.assert_array_equal(port, ref)
    # the device copy the kernels read is the same table, entry-major
    dev = curve.base_table8(torch.device("cpu"))
    assert dev.is_contiguous() and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), ref)
    assert dev.numel() * 4 == 1_966_080
    # K3's and K4's copy pairs the limbs, l[2i] + (l[2i+1] << 13), 128 B an
    # entry of which the kernels read 120
    paired = cuda_verify._base_table8_26(torch.device("cpu")).numpy()
    assert paired.shape == (32, 256, 32) and paired.dtype == np.int32
    want = (ref[..., 0::2].astype(np.int64)
            + (ref[..., 1::2].astype(np.int64) << 13)).reshape(32, 256, 30)
    np.testing.assert_array_equal(paired[..., :30], want)
    assert not paired[..., 30:].any()
    for name in ("verify_kernel8", "verify_kernel8_cached"):
        assert cuda_verify.TABLE8_ENTRY_BYTES[name] == 30 * 4


def test_fixed_base_sum8_matches_reference():
    """Seeded S bytes (the top byte too, read modulo nothing: any byte
    value) through both: the same limbs, and [S]B by the oracle."""
    rng = np.random.default_rng(8)
    s_bytes = rng.integers(0, 256, size=(32, 12)).astype(np.int32)
    s_bytes[:, 0] = 0
    s_bytes[:, 1] = np.frombuffer((jref.L - 1).to_bytes(32, "little"),
                                  np.uint8)
    got = curve.fixed_base_sum8(torch.from_numpy(s_bytes)).numpy()
    ref = np.asarray(jcurve.fixed_base_sum8(jnp.asarray(s_bytes)))
    np.testing.assert_array_equal(got, ref)
    for i in (0, 1, 5):
        s = int.from_bytes(s_bytes[:, i].astype(np.uint8).tobytes(), "little")
        x, y, z = (field.from_limbs(got[c, :, i]) for c in range(3))
        ex, ey, ez, _ = jref.scalar_mult(s, jref.BASE)
        p = jref.P
        assert (x * ez - ex * z) % p == 0 and (y * ez - ey * z) % p == 0


def test_verify_kernel8_plain_matches_reference(batch, jax8):
    *_, expect, buf, host_ok = batch
    arrays = tverify.unpack_on_device(torch.from_numpy(buf), "8")
    assert arrays["s_bytes"].shape == (32, buf.shape[1])
    np.testing.assert_array_equal(arrays["s_bytes"].numpy(), buf[64:96])
    cuda_verify.reset_launches()
    got = cuda_verify.verify_kernel8(**arrays).numpy()
    np.testing.assert_array_equal(got, jax8["uncached"])
    assert list(got & host_ok) == expect
    assert not any(cuda_verify.LAUNCHES.values())


def test_verify_kernel8_cached_plain_matches_reference(batch, jax8,
                                                       port_tables):
    *_, expect, buf, host_ok = batch
    n = buf.shape[1]
    table, ok = port_tables
    rsk = tverify._unpack_rsk_on_device(torch.from_numpy(buf[32:]), "8")
    # lanes read permuted slots of a larger arena in place; one lane names
    # a slot past the arena and verifies False
    slots = n + 5
    perm = np.random.default_rng(4).permutation(slots)[:n]
    arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32)
    arena[..., torch.from_numpy(perm)] = table
    arena_ok = torch.zeros(slots, dtype=torch.bool)
    arena_ok[torch.from_numpy(perm)] = ok
    idxs = torch.from_numpy(perm.astype(np.uint16).view(np.int16))
    got = cuda_verify.verify_kernel8_cached(arena, arena_ok, **rsk,
                                            idxs=idxs).numpy()
    np.testing.assert_array_equal(got, jax8["cached"])
    assert list(got & host_ok) == expect
    far = idxs.clone()
    far[0] = slots  # the first lane is the honest corpus signature
    assert got[0]
    again = cuda_verify.verify_kernel8_cached(arena, arena_ok, **rsk,
                                              idxs=far).numpy()
    assert not again[0] and (again[1:] == got[1:]).all()


@pytest.fixture
def xla8_mode():
    """The reference's 8-bit flavor, as its own tests select it."""
    old_mode = jverify._KERNEL_MODE
    old_cache = jverify._PUBKEY_CACHE
    jverify._KERNEL_MODE = "xla8"
    jverify._PUBKEY_CACHE = jverify.PubkeyTableCache()
    try:
        yield
    finally:
        jverify._KERNEL_MODE = old_mode
        jverify._PUBKEY_CACHE = old_cache


def test_verify_batch_flavors_match_reference_xla8(batch, jax8, xla8_mode,
                                                   monkeypatch):
    """verify_batch: flavor "8" with the cache off, cold and warm ==
    flavor "4" == the reference's verify_batch under xla8 (its uncached
    program; the cached one is held above); None reads the variable at
    call time."""
    pks, msgs, sigs, expect, _, _ = batch
    monkeypatch.setenv("COMETBFT_TPU_PUBKEY_CACHE", "0")
    j_ok, j_bits = jverify.verify_batch(pks, msgs, sigs)
    assert j_bits.tolist() == expect
    cache = tverify.PubkeyTableCache(device="cpu", capacity=len(pks))
    for flavor, c in (("8", None), ("8", cache), ("8", cache), ("4", None)):
        ok, bits = tverify.verify_batch(pks, msgs, sigs, device="cpu",
                                        cache=c, flavor=flavor)
        assert (ok, bits.tolist()) == (j_ok, j_bits.tolist()), flavor
    # built once on the cold call, every lane a hit on the warm one
    assert cache.builds == 1 and cache.hits >= len(pks)
    assert cache.hits + cache.misses == 2 * len(pks)
    cuda_verify.reset_launches()
    monkeypatch.setenv("COMETBFT_TPU_KERNEL", "xla8")
    assert tverify.kernel_flavor() == "8"
    _, bits = tverify.verify_batch(pks[-12:], msgs[-12:], sigs[-12:],
                                   device="cpu")
    assert bits.tolist() == j_bits.tolist()[-12:]
    assert not any(cuda_verify.LAUNCHES.values())


@pytest.mark.parametrize("mode,flavor", [
    (None, "4"), ("auto", "4"), ("pallas", "4"), ("xla", "4"),
    ("pallas8", "8"), ("xla8", "8"),
])
def test_kernel_env_values_map_to_flavors(monkeypatch, mode, flavor):
    if mode is None:
        monkeypatch.delenv("COMETBFT_TPU_KERNEL", raising=False)
    else:
        monkeypatch.setenv("COMETBFT_TPU_KERNEL", mode)
    assert tverify.kernel_flavor() == flavor
    assert tverify.kernel_flavor("8") == "8"  # an explicit flavor wins


def test_unknown_kernel_env_and_flavor_raise(monkeypatch, batch):
    pks, msgs, sigs = (x[:2] for x in batch[:3])
    monkeypatch.setenv("COMETBFT_TPU_KERNEL", "pallas16")
    with pytest.raises(ValueError, match="COMETBFT_TPU_KERNEL"):
        tverify.verify_batch(pks, msgs, sigs, device="cpu")
    monkeypatch.delenv("COMETBFT_TPU_KERNEL")
    with pytest.raises(ValueError, match="flavor"):
        tverify.verify_batch(pks, msgs, sigs, device="cpu", flavor=8)
    buf, _ = tverify.pack_bytes(pks, msgs, sigs)
    with pytest.raises(ValueError, match="flavor"):
        tverify.verify_bytes_async(buf, 2, device="cpu", flavor="xla8")
