"""Port verify glue and plain kernels vs the JAX reference, on the CPU.

One batch, built once per module: the ZIP-215 conformance corpus plus the
edge lanes of the Pallas kernel's test (flipped signature bit, wrong
message, wrong key, non-canonical identity key y = 1 + p, off-curve A and
R, a small-order A that only the cofactored equation accepts, S >= L).
The same wire rows go through cometbft_tpu (its XLA programs are the
Pallas kernels' plain reference) and through cometbft_tpu_torch with
device="cpu" (the CUDA kernels' plain versions). Every comparison is on
integers or bits, so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import curve as jcurve
from cometbft_tpu.ops import verify as jverify
from cometbft_tpu_torch.ops import cuda_verify
from cometbft_tpu_torch.ops import verify as tverify

from test_curve import _order8_point, make_batch
from test_zip215_conformance import build_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run thousands of ops on tiny tensors, where
    intra-op threads only add overhead (and contend with the other test
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edge_lanes():
    """The edge lanes of tests/test_pallas_verify.py, 10 lanes."""
    rng = random.Random(77)
    pks, msgs, sigs = make_batch(10)
    sigs[1] = bytes([sigs[1][0] ^ 1]) + sigs[1][1:]
    msgs[3] = b"tampered"
    pks[5] = make_batch(1)[0][0]
    pks[6] = (1 + jref.P).to_bytes(32, "little")  # identity, y = 1 + p
    sigs[6] = jref.compress(jref.scalar_mult(7, jref.BASE)) + (7).to_bytes(
        32, "little"
    )
    pks[7] = (2).to_bytes(32, "little")  # A off the curve
    sigs[8] = (2).to_bytes(32, "little") + sigs[8][32:]  # R off the curve
    a_enc = jref.compress(_order8_point())
    r_enc = jref.compress(jref.scalar_mult(5, jref.BASE))
    zmsg = next(
        b"zip215-%d" % i
        for i in range(64)
        if jref.challenge_scalar(r_enc, a_enc, b"zip215-%d" % i) % 8 != 0
    )
    pks[9], msgs[9], sigs[9] = a_enc, zmsg, r_enc + (5).to_bytes(32, "little")
    b = bytearray(sigs[2])
    b[rng.randrange(32, 64)] ^= 1 << rng.randrange(8)
    sigs[2] = bytes(b)
    return pks, msgs, sigs


@pytest.fixture(scope="module")
def batch():
    corpus = build_corpus()
    pks = [v[1] for v in corpus]
    msgs = [v[2] for v in corpus]
    sigs = [v[3] for v in corpus]
    e_pks, e_msgs, e_sigs = _edge_lanes()
    pks, msgs, sigs = pks + e_pks, msgs + e_msgs, sigs + e_sigs
    # a malformed lane: host-rejected, zeroed wire row
    pks.append(pks[0])
    msgs.append(msgs[0])
    sigs.append(sigs[0][:40])
    expect = [jref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    return pks, msgs, sigs, expect


@pytest.fixture(scope="module")
def wire(batch):
    pks, msgs, sigs, _ = batch
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    return buf, host_ok


@pytest.fixture(scope="module")
def jax_results(wire):
    """The JAX reference, run once: tables and both verify kernels."""
    buf, _ = wire
    arrays = {
        k: jnp.asarray(v)
        for k, v in jverify.unpack_on_device(jnp.asarray(buf)).items()
    }
    table, tab_ok = jcurve.build_pubkey_tables(arrays["y_a"], arrays["sign_a"])
    uncached = jcurve.verify_kernel(**arrays)
    cached = jcurve.verify_kernel_cached(
        table, arrays["y_r"], arrays["sign_r"], arrays["s_nibs"],
        arrays["kneg_nibs"],
    )
    return {
        "table": np.asarray(table),
        "tab_ok": np.asarray(tab_ok),
        "uncached": np.asarray(uncached),
        "cached": np.asarray(cached) & np.asarray(tab_ok),
    }


@pytest.fixture(scope="module")
def port_arrays(wire):
    buf, _ = wire
    return tverify.unpack_on_device(torch.from_numpy(buf))


def test_pack_bytes_byte_identical(batch, wire):
    pks, msgs, sigs, _ = batch
    j_buf, j_ok = jverify.pack_bytes(pks, msgs, sigs)
    t_buf, t_ok = wire
    assert t_buf.dtype == np.uint8 and t_buf.shape == (128, len(pks))
    assert t_buf.tobytes() == np.ascontiguousarray(j_buf).tobytes()
    np.testing.assert_array_equal(t_ok, j_ok)
    assert not t_ok[-1]  # the truncated signature


def test_bucket_size_matches_reference():
    for n in list(range(1, 70)) + [511, 1000, 1025, 1536, 4097, 10000, 16384]:
        assert tverify.bucket_size(n) == jverify.bucket_size(n), n


def test_unpack_on_device_matches(wire, port_arrays):
    buf, _ = wire
    j = jverify.unpack_on_device(jnp.asarray(buf))
    assert set(j) == set(port_arrays)
    for k, v in port_arrays.items():
        assert v.dtype == torch.int32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(j[k]), err_msg=k)
    rsk = tverify._unpack_rsk_on_device(torch.from_numpy(buf[32:]))
    for k, v in rsk.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j[k]), err_msg=k)


def test_ok_bit_packing_matches():
    rng = np.random.default_rng(5)
    ok = rng.integers(0, 2, size=64).astype(bool)
    j = np.asarray(jverify._pack_ok_bits(jnp.asarray(ok)))
    t = tverify._pack_ok_bits(torch.from_numpy(ok)).numpy()
    assert t.dtype == np.uint8
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tverify.unpack_ok_bits(t, 61), ok[:61])


def test_build_pubkey_tables_matches(port_arrays, jax_results):
    table, ok = cuda_verify.build_pubkey_tables(
        port_arrays["y_a"], port_arrays["sign_a"]
    )
    np.testing.assert_array_equal(table.numpy(), jax_results["table"])
    np.testing.assert_array_equal(ok.numpy(), jax_results["tab_ok"])


def test_verify_kernel_plain_matches(batch, wire, port_arrays, jax_results):
    got = cuda_verify.verify_kernel(**port_arrays).numpy()
    np.testing.assert_array_equal(got, jax_results["uncached"])
    _, host_ok = wire
    assert list(got & host_ok) == batch[3]  # and the ZIP-215 oracle


def test_verify_kernel_cached_plain_matches(batch, wire, port_arrays,
                                            jax_results):
    table, ok = cuda_verify.build_pubkey_tables(
        port_arrays["y_a"], port_arrays["sign_a"]
    )
    rsk = {k: port_arrays[k] for k in ("y_r", "sign_r", "s_nibs", "kneg_nibs")}
    n = table.shape[-1]
    lanes = torch.arange(n, dtype=torch.int16)
    got = cuda_verify.verify_kernel_cached(table, ok, **rsk, idxs=lanes).numpy()
    np.testing.assert_array_equal(got, jax_results["cached"])
    # lanes read permuted slots in place
    perm = np.random.default_rng(3).permutation(n)
    arena = table[..., perm]
    arena_ok = ok[perm]
    inv = np.argsort(perm).astype(np.uint16).view(np.int16)
    got2 = cuda_verify.verify_kernel_cached(
        arena, arena_ok, **rsk, idxs=torch.from_numpy(inv)
    ).numpy()
    np.testing.assert_array_equal(got2, got)
    _, host_ok = wire
    assert list(got & host_ok) == batch[3]


def test_verify_batch_cpu_cache_on_and_off(batch):
    """The slice's batch entry agrees with the oracle with the pubkey
    cache off (K1 path) and on (K2 path, cold then warm)."""
    pks, msgs, sigs, expect = batch
    sub = slice(0, 12)
    ok_off, bits_off = tverify.verify_batch(
        pks[sub], msgs[sub], sigs[sub], device="cpu"
    )
    cache = tverify.PubkeyTableCache(device="cpu", capacity=16)
    ok_on, bits_on = tverify.verify_batch(
        pks[sub], msgs[sub], sigs[sub], device="cpu", cache=cache
    )
    assert list(bits_off) == list(bits_on) == expect[sub]
    assert ok_off == ok_on == all(expect[sub])
    assert cache.builds == 1 and cache.hits == 0


def test_pubkey_cache_evicts_least_recent_unused_key():
    """A full arena reuses the slot of the least recently used key that
    the call does not read; the keys it reads keep their slots."""
    keys = [bytes([i]) * 32 for i in range(6)]
    cache = tverify.PubkeyTableCache(device="cpu", capacity=4)
    first, _, _ = cache.lookup(keys[:4])
    assert sorted(first.tolist()) == [0, 1, 2, 3]
    cache.lookup([keys[0]])  # keys[1] is now the least recent
    idxs, arena, arena_ok = cache.lookup([keys[2], keys[4]])
    assert idxs.tolist() == [first[2], first[1]]
    assert cache.builds == 2 and cache.misses == 5 and cache.hits == 2
    # the new key's table sits in the reused slot
    y = tverify._dev_y_limbs(
        tverify._dev_le_bits(torch.tensor([[b] for b in keys[4]],
                                          dtype=torch.int32))
    )
    table, _ = cuda_verify.build_pubkey_tables(
        y, torch.zeros(1, dtype=torch.int32)
    )
    assert torch.equal(arena[..., int(idxs[1])], table[..., 0])
