"""The port's multi-device verify path vs the JAX package, on the CPU.

cometbft_tpu_torch/parallel/mesh.py and the sharded branch of
ops/verify.verify_batch against cometbft_tpu's: the host limb packer
(pack_inputs), verify_sharded on a (2, 4) mesh with corrupt and
host-rejected lanes, and _verify_batch_sharded's padding. The reference
runs on conftest.py's 8 virtual CPU devices; the port's mesh names the
CPU eight times (["cpu"] * 8), where each shard runs K1's plain version
(~1 s a call on a CPU, whatever its lanes). Verdicts, padded widths and
arrays must be exactly equal. Then the port's own dispatch rules: the
_shard_devices decision table, the 4-bit K1 on the sharded route
whatever the flavor, and a failing shard that must raise out of
verify_batch. The ragged case is test_torch_mesh_ragged.py's: each
reference shape costs a cold XLA compile of ~24 s, and each file keeps
to one.
"""

import numpy as np
import pytest
import torch

import jax

from cometbft_tpu.ops import verify as jverify
from cometbft_tpu.parallel import mesh as jmesh
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.libs import accel as taccel
from cometbft_tpu_torch.ops import cuda_verify as tcv
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, seed=11, corrupt=(), s_plus_l=(), short=()):
    """n lanes over three seeded keys; ``corrupt`` lanes get a flipped
    signature byte, ``s_plus_l`` lanes S + L (non-canonical: the host
    rejects them), ``short`` lanes a truncated signature."""
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(3)]
    keys = [(s, ref.pubkey_from_seed(s)) for s in seeds]
    pubkeys, msgs, sigs = [], [], []
    for i in range(n):
        s, pk = keys[i % 3]
        m = rng.bytes(40)
        sig = ref.sign(s, m)
        if i in corrupt:
            sig = sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]
        if i in s_plus_l:
            big = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + big.to_bytes(32, "little")
        if i in short:
            sig = sig[:40]
        pubkeys.append(pk)
        msgs.append(m)
        sigs.append(sig)
    return pubkeys, msgs, sigs


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return (jmesh.make_mesh(jax.devices()[:8], commit_axis=2),
            tmesh.make_mesh(["cpu"] * 8, commit_axis=2))


def test_pack_inputs_equals_the_reference():
    """Array for array equal values; the port's nibbles are int32 where the
    reference's sum widens them to int64 (JAX narrows them on the copy to
    the device; K1 takes int32), so 680 B a lane against 1,192."""
    pubkeys, msgs, sigs = _batch(12, corrupt={1}, s_plus_l={4}, short={7})
    ours, ok_t = tverify.pack_inputs(pubkeys, msgs, sigs)
    theirs, ok_j = jverify.pack_inputs(pubkeys, msgs, sigs)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == np.int32 and ours[k].shape == theirs[k].shape
        assert np.array_equal(ours[k], theirs[k]), k
    assert theirs["s_nibs"].dtype == theirs["kneg_nibs"].dtype == np.int64
    assert np.array_equal(ok_t, ok_j) and ok_t.tolist().count(False) == 2
    assert sum(v.nbytes for v in ours.values()) == 680 * 12
    assert sum(v.nbytes for v in theirs.values()) == 1192 * 12


def _both_sharded(meshes, n_commits, n_sigs, **spoil):
    """verify_sharded of the reference and the port on the same lanes:
    (ours, theirs, the oracle's verdicts, the port's launches as (lanes,
    device type))."""
    pubkeys, msgs, sigs = _batch(n_commits * n_sigs, **spoil)
    jarr, jok = jverify.pack_inputs(pubkeys, msgs, sigs)
    tarr, tok = tverify.pack_inputs(pubkeys, msgs, sigs)
    theirs = jmesh.verify_sharded(jarr, jok, meshes[0], n_commits, n_sigs)
    launches = []
    real = tcv.verify_kernel

    def counted(*a):
        launches.append((a[0].shape[-1], a[0].device.type))
        return real(*a)

    tcv.verify_kernel = counted
    try:
        ours = tmesh.verify_sharded(tarr, tok, meshes[1], n_commits, n_sigs)
    finally:
        tcv.verify_kernel = real
    oracle = np.array([ref.verify(p, m, s) for p, m, s in
                       zip(pubkeys, msgs, sigs)]).reshape(n_commits, n_sigs)
    return ours, theirs, oracle, launches


@pytest.fixture(scope="module")
def two_by_eight(meshes):
    """2 commits x 8 signatures on the (2, 4) mesh (the reference's
    tests/test_parallel.py case): lanes 3 and 9 corrupt, lane 2 with S + L
    and lane 13 cut short (both rejected on the host)."""
    return _both_sharded(meshes, 2, 8, corrupt={3, 9}, s_plus_l={2},
                         short={13})


def test_sharded_matches_the_reference(two_by_eight):
    """Bit-identical to the reference's verify_sharded and to the oracle,
    (n_commits, n_sigs) bool."""
    ours, theirs, oracle, _ = two_by_eight
    assert ours.dtype == bool and ours.shape == oracle.shape
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, oracle)


def test_sharded_names_the_corrupt_lanes(two_by_eight):
    ours = two_by_eight[0]
    assert not ours.ravel()[3] and not ours.ravel()[9]


def test_sharded_rejects_host_invalid_lanes(two_by_eight):
    """A non-canonical S (S + L) and a short signature ride zeroed rows,
    which decode to a small-order point the cofactored check accepts: the
    host AND keeps them False, and no other lane but the corrupt ones."""
    ours = two_by_eight[0]
    assert np.flatnonzero(~ours.ravel()).tolist() == [2, 3, 9, 13]


def test_make_mesh_divisibility_and_layout():
    mesh = tmesh.make_mesh(["cpu"] * 6, commit_axis=3)
    assert mesh.devices.shape == (3, 2) and mesh.shape == {"commit": 3,
                                                           "sig": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    with pytest.raises(ValueError, match="not divisible by commit_axis=4"):
        tmesh.make_mesh(["cpu"] * 6, commit_axis=4)
    assert tmesh.pad_to(10, 4) == 12 and tmesh.pad_to(8, 4) == 8


def _spy_width(monkeypatch, mod):
    """Record the lane width each verify_sharded call is given."""
    seen = []
    real = mod.verify_sharded

    def spy(arrays, host_ok, mesh, n_commits, n_sigs):
        seen.append((arrays["y_a"].shape[-1], host_ok.shape[0], n_sigs))
        return real(arrays, host_ok, mesh, n_commits, n_sigs)

    monkeypatch.setattr(mod, "verify_sharded", spy)
    return seen


def test_verify_batch_sharded_matches_the_reference(meshes, monkeypatch):
    """_verify_batch_sharded with the same n_dev (1) and mesh ((2, 4)) on
    both sides: 5 lanes pad to 8 (host_ok with False), then the commit
    axis to 2; the same width and verdicts. (The reference's default mesh
    is patched to the (2, 4) one: its program for that mesh and shape is
    the one test_sharded_matches_the_reference compiled, and a cold XLA
    compile costs ~24 s on a CPU.)"""
    pubkeys, msgs, sigs = _batch(5, seed=12, corrupt={1}, s_plus_l={3})
    monkeypatch.setattr(jmesh, "default_mesh", lambda: meshes[0])
    jseen = _spy_width(monkeypatch, jmesh)
    tseen = _spy_width(monkeypatch, tmesh)
    j_all, j_ok = jverify._verify_batch_sharded(pubkeys, msgs, sigs, 1)
    t_all, t_ok = tverify._verify_batch_sharded(pubkeys, msgs, sigs, 1,
                                                mesh=meshes[1])
    assert jseen == tseen == [(8, 8, 8)]
    assert (t_all, t_ok.tolist()) == (j_all, j_ok.tolist())
    assert np.flatnonzero(~t_ok).tolist() == [1, 3]


@pytest.mark.parametrize("n, n_dev, width", [
    (1, 1, 8), (8, 1, 8), (9, 1, 16), (24, 2, 32), (24, 8, 64),
    (10_000, 1, 16_384), (10_000, 4, 16_384), (40_000, 4, 65_536)])
def test_sharded_padding_rule(n, n_dev, width):
    """n_dev x a power of two from _MIN_BUCKET: the widths the card sees
    (10,000 lanes: 16,384 on one device, 4 x 4,096 on four; 40,000: 4 x
    16,384)."""
    per_dev = tverify._MIN_BUCKET
    while per_dev * n_dev < n:
        per_dev *= 2
    assert per_dev * n_dev == width


class _Cache:
    device = torch.device("cpu")


@pytest.mark.parametrize("mode, count, device, cache, sharded", [
    ("0", 4, "cuda", None, False),
    ("auto", 0, "cuda", None, False),
    ("auto", 1, "cuda", None, False),
    ("auto", 2, "cuda", None, True),
    ("1", 2, "cuda", None, True),
    ("auto", 4, "cuda:1", None, True),
    ("1", 4, "cpu", None, False),
    ("auto", 4, "cpu", None, False),
    ("auto", 4, "cuda", _Cache(), False),
    ("1", 4, "cuda", _Cache(), False),
])
def test_shard_devices_decision_table(monkeypatch, mode, count, device,
                                      cache, sharded):
    """(COMETBFT_TPU_SHARD, CUDA devices, device=, cache=) -> sharded over
    every CUDA device or the single-device route. An explicit cache keeps
    the single-device route: the arena names one device."""
    monkeypatch.setenv("COMETBFT_TPU_SHARD", mode)
    monkeypatch.setattr(taccel, "cuda_device_count", lambda: count)
    got = tverify._shard_devices(torch.device(device), cache)
    if sharded:
        assert got == [torch.device("cuda", i) for i in range(count)]
    else:
        assert got is None


def test_shard_devices_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_SHARD", "yes")
    with pytest.raises(ValueError, match="COMETBFT_TPU_SHARD"):
        tverify._shard_devices(torch.device("cuda"))


@pytest.fixture
def sharded_route(monkeypatch):
    """verify_batch on the CPU takes the sharded route over ["cpu"] * 2;
    returns the (kernel, lanes) of every verify launch."""
    mesh = tmesh.make_mesh(["cpu"] * 2)
    monkeypatch.setattr(tverify, "_shard_devices",
                        lambda device, cache=None: list(
                            mesh.devices.ravel()))
    monkeypatch.setattr(tmesh, "default_mesh", lambda: mesh)
    launches = []
    for name in ("verify_kernel", "verify_kernel8", "verify_kernel_cached",
                 "verify_kernel8_cached"):
        def counted(*a, _real=getattr(tcv, name), _name=name, **k):
            launches.append((_name, (list(a) + list(k.values()))[2]
                             .shape[-1]))
            return _real(*a, **k)
        monkeypatch.setattr(tcv, name, counted)
    return launches


def test_sharded_route_runs_k1_for_the_8bit_flavor(sharded_route,
                                                   monkeypatch):
    """flavor "8" on the sharded route runs the 4-bit K1, once a shard (the
    8-bit kernels take S as bytes, which pack_inputs does not ship), with
    the verdicts of the single-device route."""
    pubkeys, msgs, sigs = _batch(24, corrupt={11}, short={3})
    ok_all, ok = tverify.verify_batch(pubkeys, msgs, sigs, device="cpu",
                                      flavor="8")
    assert sharded_route == [("verify_kernel", 16)] * 2  # 32 lanes / 2
    monkeypatch.setattr(tverify, "_shard_devices",
                        lambda device, cache=None: None)
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})
    want_all, want = tverify.verify_batch(pubkeys, msgs, sigs, device="cpu",
                                          flavor="8")
    assert sharded_route[2:] == [("verify_kernel8_cached", 24)]
    assert (ok_all, ok.tolist()) == (want_all, want.tolist())
    assert np.flatnonzero(~ok).tolist() == [3, 11]


def test_a_failing_shard_raises_out_of_verify_batch(sharded_route,
                                                    monkeypatch):
    """No fallback: a shard whose kernel raises fails the whole call."""
    calls = []
    real = tcv.verify_kernel

    def second_fails(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("verify_kernel: CUDA launch failed")
        return real(*a)

    monkeypatch.setattr(tcv, "verify_kernel", second_fails)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tverify.verify_batch(*_batch(10), device="cpu")
    assert len(calls) == 2
