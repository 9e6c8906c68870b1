"""The port's RLC batch equation (ops/rlc.py, X5) vs the JAX package, on
the CPU.

The host half must be the reference's exactly: bucket sizes, window
widths, signed digits, MSM plans (perm, sign, starts, ends) and
op_ledger. The plain device functions (_masked_decompress,
_msm_window_sums, _horner, _rlc_kernel) run on seeded inputs at one
(A bucket, R bucket) shape beside the reference's, run eagerly (each
shape costs the reference tens of seconds of XLA compiles here): points
agree as encodings (the association orders differ, so limbs may not),
decompressions limb for limb, bools exactly. The cases of
tests/test_rlc.py run through verify_batch_rlc(device="cpu"), each
bitmap held against ed25519_ref lane by lane, and check_equation against
the native engine's MSM (host_batch._msm_identity). Where g++ is on the
path, X5's source (csrc/rlc.cu) runs on tests/test_torch_fe26.py's fiber
stub at buckets 8 and 16, with runs of 8, 4 and 2 buckets, on seeded
lanes and an undecodable R: its window sums and pre-cofactor total equal
the plain version's as encodings, and its byte the plain bool.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import test_torch_fe26 as fe26
from cometbft_tpu.ops import curve as jcurve
from cometbft_tpu.ops import rlc as jrlc
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.crypto import host_batch
from cometbft_tpu_torch.ops import cuda_rlc, cuda_verify, curve, rlc
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.ops.build import CSRC

L = ref.L


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small tensor ops: one intra-op thread
    runs them faster here, and keeps out of the other test workers' way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keypairs(n, seed=0):
    out = []
    for i in range(n):
        s = bytes([seed]) + i.to_bytes(4, "little") + bytes(27)
        out.append((s, ref.pubkey_from_seed(s)))
    return out


def _signed_batch(n, seed=0, n_keys=None):
    pairs = _keypairs(n_keys or n, seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        sd, pk = pairs[i % len(pairs)]
        m = b"msg-%d-%d" % (seed, i)
        pks.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(sd, m))
    return pks, msgs, sigs


def _digits_value(digits, c):
    return sum(int(d) << (c * j) for j, d in enumerate(digits))


def _undecodable_y() -> bytes:
    y = next(y for y in range(2, 300)
             if ref.decompress(y.to_bytes(32, "little")) is None)
    return y.to_bytes(32, "little")


# ------------------------------------------------------------- host half


def test_buckets_and_window_widths_are_the_references():
    for n in [1, 7, 8, 9, 100, 4096, 10_000, 40_000, 70_000]:
        assert rlc._bucket(n) == jrlc._bucket(n)
    for e in range(3, 18):
        for nbits in (rlc.A_BITS, rlc.R_BITS):
            assert rlc.window_bits(1 << e, nbits) == jrlc.window_bits(
                1 << e, nbits)


@pytest.mark.parametrize("c", [4, 7, 10, 12])
def test_signed_digits_roundtrip_and_equal_the_reference(c):
    rng = np.random.default_rng(7)
    vals = [int.from_bytes(rng.bytes(32), "little") % (1 << 253)
            for _ in range(16)]
    rows = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                     for v in vals])
    digs = rlc.signed_digits(rows, c, 253)
    np.testing.assert_array_equal(digs, jrlc.signed_digits(rows, c, 253))
    half = 1 << (c - 1)
    assert digs.max() <= half and digs.min() >= -half
    for i, v in enumerate(vals):
        assert _digits_value(digs[:, i], c) == v


def test_digits_and_limbs_from_words_equal_the_references_bit_arrays():
    """signed_digits and the y limbs read bit fields of 64-bit words where
    the reference unpacks every bit: the same arrays at every window
    width, on random scalars of both widths and on encodings with y >= p,
    y's top bits set and either sign."""
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 256, (257, 32), np.uint8).astype(np.uint8)
    rows[:40, 31] |= 0x7F  # y >= p, top limb full
    rows[:3] = 255
    rows[3:5] = 0
    short = rows.copy()
    short[:, 16:] = 0
    for c in range(4, 13):
        np.testing.assert_array_equal(rlc.signed_digits(short, c, 128),
                                      jrlc.signed_digits(short, c, 128))
        wide = rows.copy()
        wide[:, 31] &= 0x1F  # below 2^253, as every folded A scalar is
        np.testing.assert_array_equal(rlc.signed_digits(wide, c, 253),
                                      jrlc.signed_digits(wide, c, 253))
    encs = [r.tobytes() for r in rows]
    for n_pad in (257, 512):
        for got, want in zip(rlc._enc_arrays(encs, n_pad),
                             jrlc._enc_arrays(encs, n_pad)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,nbits,n", [(8, 253, 32), (4, 128, 8),
                                       (11, 253, 64), (12, 128, 40)])
def test_plan_equals_the_reference_and_bounds_each_bucket(c, nbits, n):
    rng = np.random.default_rng(3 + c)
    rows = rng.integers(0, 256, (n, 32), np.uint8).astype(np.uint8)
    if nbits == 128:
        rows[:, 16:] = 0
    plan = rlc.plan_msm(rows, c, nbits)
    want = jrlc.plan_msm(rows, c, nbits)
    for k in rlc.PLAN_KEYS:
        assert plan[k].dtype == np.int32
        np.testing.assert_array_equal(plan[k], want[k])
    digs = rlc.signed_digits(rows, c, nbits)
    srt = np.take_along_axis(np.abs(digs), plan["perm"], axis=1)
    assert (np.diff(srt, axis=1) >= 0).all()
    m = 1 << (c - 1)
    for j in range(digs.shape[0]):
        for v in (1, 2, m // 2, m):
            seg = srt[j, plan["starts"][j, v - 1]: plan["ends"][j, v - 1]]
            assert (seg == v).all() and (srt[j] == v).sum() == len(seg)


def test_launch_inputs_equal_the_references_arrays():
    """_enc_arrays (pad lanes the identity encoding y = 1), _scalar_rows
    and the plans of check_equation's launch, array for array."""
    encs = [pk for _, pk in _keypairs(5, 4)] + [_undecodable_y()]
    scal = [(7 ** (i + 40)) % L for i in range(6)]
    inp = rlc.launch_inputs(encs, scal, encs[:3], [3, 5, 1 << 127], 99)
    for got, want in zip(rlc._enc_arrays(encs, 8), jrlc._enc_arrays(encs, 8)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rlc._scalar_rows(scal, 8),
                                  jrlc._scalar_rows(scal, 8))
    y_a, sign_a = jrlc._enc_arrays(encs, 8)
    np.testing.assert_array_equal(inp["y_a"], y_a)
    np.testing.assert_array_equal(inp["sign_a"], sign_a)
    want = jrlc.plan_msm(jrlc._scalar_rows(scal, 8), inp["c_a"], 253)
    for got, k in zip(inp["plan_a"], rlc.PLAN_KEYS):
        np.testing.assert_array_equal(got, want[k])
    assert inp["b_bytes"].shape == (32, 1) and inp["b_bytes"][0, 0] == 99


@pytest.mark.parametrize("n,keys", [(256, None), (4096, None), (4096, 150),
                                    (10_000, None), (40_000, 10_000)])
def test_op_ledger_equals_the_reference(n, keys):
    assert rlc.op_ledger(n, keys) == jrlc.op_ledger(n, keys)


def test_x5_work_counts_what_the_plans_need():
    """cuda_rlc.work's field products against a count from the signed
    digits themselves: a decompression for each lane with a nonzero
    digit, an add for each nonzero digit and 2m for each window's running
    sums, Horner, [b]B and the cofactor; pad lanes (scalar 0) cost
    nothing, so it stays below op_ledger's count of every slot."""
    a_sc = [(7 ** (i + 40)) % L for i in range(5)] + [0]
    r_sc = [3, 5, 1 << 127, 1]
    sides = []
    for sc, n_pad, nbits in ((a_sc, 16, 253), (r_sc, 8, 128)):
        c = rlc.window_bits(n_pad, nbits)
        rows = rlc._scalar_rows(sc, n_pad)
        plan = rlc.plan_msm(rows, c, nbits)
        sides.append((tuple(plan[k] for k in rlc.PLAN_KEYS), c,
                      rlc.signed_digits(rows, c, nbits)))
    (plan_a, c_a, dig_a), (plan_r, c_r, dig_r) = sides
    ops, nbytes = cuda_rlc.work(plan_a, plan_r, c_a, c_r)
    adds, dbls, points = 32 + 2, 3, 0
    for (_, c, digs) in sides:
        w = digs.shape[0]
        points += int((digs != 0).any(axis=0).sum())
        adds += int((digs != 0).sum()) + 2 * (1 << (c - 1)) * w + w - 1
        dbls += (w - 1) * c
    assert points == 5 + 4  # the scalar-0 lane and the pad lanes: none
    products = 9 * adds + 8 * dbls + 265 * points
    assert ops == 2 * cuda_rlc.MULADDS_PER_PRODUCT * products
    assert products < rlc.op_ledger(8, 16)["field_muls_total"]
    assert nbytes > 4 * 20 * (16 + 8)


def test_op_ledger_amortizes_as_the_reference_promises():
    led = rlc.op_ledger(4096, n_keys=150)
    assert led["msm_muls_per_sig"] < 500 and led["field_muls_per_sig"] < 1000
    assert rlc.op_ledger(4096)["field_muls_per_sig"] < 2400
    assert (rlc.op_ledger(4096)["field_muls_per_sig"]
            < rlc.op_ledger(256)["field_muls_per_sig"])


def test_fold_is_the_references_loop():
    """The A side folds by distinct key in first-seen order, R's sign bit
    flips, z = max(1, 16 LE bytes), b = sum z s mod L: the reference's
    verify_batch_rlc loop, on one draw of bytes."""
    pks, msgs, sigs = _signed_batch(12, seed=11, n_keys=4)
    sigs[5] = b"short"
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    zb = bytes(16) + bytes(range(1, 161))  # lane 0's z is 0 -> 1
    a_keys, a_sc, r_encs, r_sc, b = rlc.fold(buf, host_ok, zb)
    well = np.nonzero(host_ok)[0]
    want_a, want_b = {}, 0
    for j, i in enumerate(well):
        z = max(1, int.from_bytes(zb[16 * j: 16 * j + 16], "little"))
        assert r_sc[j] == z
        r = buf[32:64, i].tobytes()
        assert r_encs[j] == r[:31] + bytes([r[31] ^ 0x80])
        a = buf[0:32, i].tobytes()
        kneg = int.from_bytes(buf[96:128, i].tobytes(), "little")
        want_a[a] = (want_a.get(a, 0) + z * kneg) % L
        want_b = (want_b + z * int.from_bytes(buf[64:96, i].tobytes(),
                                              "little")) % L
    assert list(zip(a_keys, a_sc)) == list(want_a.items()) and b == want_b
    assert len(a_keys) == 4 and r_sc[0] == 1


# ----------------------------------- plain device functions vs the reference


def _point_enc(x: int) -> bytes:
    return ref.compress(ref.scalar_mult(x, ref.BASE))


@pytest.fixture(scope="module")
def msm():
    """One (A bucket 8, R bucket 8) launch: A = [x_i]B for five keys and
    R = [y_i]B for seven points, b chosen so the equation holds; then the
    same with b + 1 and with one R undecodable. Returns the inputs, the
    reference's parts (decompressions, window sums, Horner sums, total)
    and bools, run eagerly, and the port's plain parts."""
    rng = np.random.default_rng(2718)

    def rand(bits):
        return int.from_bytes(rng.bytes(32), "little") % (1 << bits)

    xs = [rand(252) for _ in range(5)]
    ys = [rand(252) for _ in range(7)]
    a_sc = [rand(252) % L for _ in xs]
    r_sc = [max(1, rand(128)) for _ in ys]
    b = -(sum(a * x for a, x in zip(a_sc, xs))
          + sum(r * y for r, y in zip(r_sc, ys))) % L
    a_encs = [_point_enc(x) for x in xs]
    r_encs = [_point_enc(y) for y in ys]
    r_bad = r_encs[:6] + [_undecodable_y()] + r_encs[7:]
    args = {"holds": (a_encs, a_sc, r_encs, r_sc, b),
            "b_plus_1": (a_encs, a_sc, r_encs, r_sc, (b + 1) % L),
            "undecodable_r": (a_encs, a_sc, r_bad, r_sc, b),
            # only the ok bit fails this one: the undecodable R's scalar
            # is 0, so the sums still hold
            "undecodable_zero": (a_encs, a_sc, r_encs + [_undecodable_y()],
                                 r_sc + [0], b)}
    oracle = {k: host_batch._msm_identity(
        b"".join(v[0] + v[2] + [host_batch._B_ENC]),
        b"".join(s.to_bytes(32, "little") for s in v[1] + v[3] + [v[4]]),
        len(v[0]) + len(v[2]) + 1) for k, v in args.items()}
    assert oracle == {"holds": 1, "b_plus_1": 0, "undecodable_r": -(2 + 11),
                      "undecodable_zero": -(2 + 12)}
    cases = {k: rlc.launch_inputs(*v) for k, v in args.items()}
    want, got = {}, {}
    for name, inp in cases.items():
        assert (inp["y_a"].shape[1], inp["y_r"].shape[1]) == (8, 8)
        got[name] = rlc._rlc_parts(**rlc.to_device(inp, "cpu"))
        if name in ("b_plus_1", "undecodable_zero"):  # held to the oracle
            continue
        j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                 else tuple(jnp.asarray(a) for a in v)
                 if isinstance(v, tuple) else v) for k, v in inp.items()}
        want[name] = {}
        # the reference's parts; "undecodable_r" shares A with "holds"
        for side in ("a", "r") if name == "holds" else ("r",):
            pts, ok = jrlc._masked_decompress(j[f"y_{side}"],
                                              j[f"sign_{side}"])
            ws = jrlc._msm_window_sums(pts, *j[f"plan_{side}"])
            want[name].update({f"{side}_pts": np.asarray(pts),
                               f"ok_{side}": np.asarray(ok),
                               f"ws_{side}": np.asarray(ws),
                               f"h_{side}": np.asarray(jrlc._horner(
                                   ws, inp[f"c_{side}"]))[:, :, None]})
        if name == "holds":
            sb = jcurve.fixed_base_sum8(j["b_bytes"])[:, :, 0]
            want[name]["total"] = np.asarray(jcurve.point_add(
                jcurve.point_add(sb, want[name]["h_a"][:, :, 0]),
                want[name]["h_r"][:, :, 0]))[:, :, None]
            want[name]["ok"] = bool(jrlc._rlc_kernel(**j))
    return cases, want, got


def test_masked_decompress_equals_the_reference_limb_for_limb(msm):
    cases, want, _ = msm
    for name, side in (("holds", "a"), ("holds", "r"),
                       ("undecodable_r", "r")):
        inp = cases[name]
        pts, ok = rlc._masked_decompress(
            torch.from_numpy(inp[f"y_{side}"]),
            torch.from_numpy(inp[f"sign_{side}"]))
        np.testing.assert_array_equal(pts.numpy(), want[name][f"{side}_pts"])
        np.testing.assert_array_equal(ok.numpy(), want[name][f"ok_{side}"])
    assert not want["undecodable_r"]["ok_r"][6]
    # the masked lane is the identity, like the pad lanes
    assert rlc.encode(want["undecodable_r"]["r_pts"][:, :, 6:7]) == [
        (1).to_bytes(32, "little")]


def test_window_sums_horner_and_total_equal_the_reference_as_points(msm):
    cases, want, got = msm
    for name, sides in (("holds", "ar"), ("undecodable_r", "r")):
        inp = cases[name]
        parts = dict(zip("ar", got[name][:2]))
        for side in sides:
            ws = parts[side]
            nbits = rlc.A_BITS if side == "a" else rlc.R_BITS
            assert ws.shape == (4, 20, rlc.windows(inp[f"c_{side}"], nbits))
            assert rlc.encode(ws) == rlc.encode(want[name][f"ws_{side}"])
            h = rlc._horner(ws, inp[f"c_{side}"])[:, :, None]
            assert rlc.encode(h) == rlc.encode(want[name][f"h_{side}"])
    assert rlc.encode(got["holds"][2][:, :, None]) == rlc.encode(
        want["holds"]["total"])
    # b aside, "b_plus_1" has the points of "holds"
    for a, b in zip(got["b_plus_1"][:2], got["holds"][:2]):
        assert rlc.encode(a) == rlc.encode(b)


def test_rlc_kernel_bool_equals_the_reference_and_the_oracle(msm):
    """The reference's _rlc_kernel on "holds"; the native MSM decided all
    three cases in the fixture."""
    cases, want, got = msm
    assert want["holds"]["ok"] is True
    expect = {"holds": True, "b_plus_1": False, "undecodable_r": False,
              "undecodable_zero": False}
    for name, inp in cases.items():
        assert bool(got[name][3]) == expect[name]
    assert bool(rlc._rlc_kernel(**rlc.to_device(cases["holds"], "cpu")))
    # the wrapper on CPU tensors is the plain version, and counts none
    assert not bool(cuda_rlc.rlc_equation(
        **rlc.to_device(cases["b_plus_1"], "cpu")))
    assert cuda_rlc.LAUNCHES == {"rlc": 0}
    # the undecodable lane is masked out of the sums: the total moves,
    # and only the ok bit fails the equation
    assert rlc.encode(got["undecodable_r"][2][:, :, None]) != rlc.encode(
        got["holds"][2][:, :, None])
    # with its scalar 0 the undecodable R leaves the total the identity
    # after [8]: the ok bit alone makes the bool False
    total = got["undecodable_zero"][2]
    for _ in range(3):
        total = curve.point_double(total)
    assert bool(curve.is_identity(total))


def test_point_double_n_and_const_points_match_the_reference():
    pts, _ = curve.decompress(*(torch.from_numpy(a) for a in rlc._enc_arrays(
        [pk for _, pk in _keypairs(3, 9)], 8)))
    jpts, _ = jcurve.decompress(*(jnp.asarray(a) for a in jrlc._enc_arrays(
        [pk for _, pk in _keypairs(3, 9)], 8)))
    np.testing.assert_array_equal(curve.point_double_n(pts, 5).numpy(),
                                  np.asarray(jcurve.point_double_n(jpts, 5)))
    ident = curve.broadcast_point(curve.const_point(curve.IDENTITY_INT), (2, 3))
    assert ident.shape == (4, 20, 2, 3)
    np.testing.assert_array_equal(
        ident.numpy(), np.asarray(jcurve.broadcast_point(
            jcurve.const_point(jcurve.IDENTITY_INT), (2, 3))))


# ----------------------------------------------- the equation and the entry


def _check_against_oracle(a_encs, a_sc, r_encs, r_sc, b) -> bool:
    got = rlc.check_equation(a_encs, a_sc, r_encs, r_sc, b, device="cpu")
    res = host_batch._msm_identity(
        b"".join(list(a_encs) + list(r_encs) + [host_batch._B_ENC]),
        b"".join(s.to_bytes(32, "little") for s in list(a_sc) + list(r_sc)
                 + [b]),
        len(a_encs) + len(r_encs) + 1)
    assert got == (res == 1), (got, res)
    return got


def test_check_equation_trivial_base_and_cancellation():
    assert _check_against_oracle([], [], [], [], 0)
    assert not _check_against_oracle([], [], [], [], 1)
    # [z]P with P == -B folds against [z]B
    z = 12345678901234567890
    bx, by = curve.BASE_INT[0], curve.BASE_INT[1]
    enc = bytearray(by.to_bytes(32, "little"))
    enc[31] |= 0x80 if (ref.P - bx) & 1 else 0
    assert _check_against_oracle([bytes(enc)], [z], [], [], z)
    assert not _check_against_oracle([bytes(enc)], [z], [], [], z + 1)


def test_check_equation_on_seeded_scalars_agrees_with_the_oracle():
    """Seeded (not secrets-drawn) z over a folded batch: True, then one
    R scalar off by one: False, both as the native MSM decides."""
    pks, msgs, sigs = _signed_batch(11, seed=12, n_keys=4)
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    zb = np.random.default_rng(12).bytes(16 * 11)
    folded = rlc.fold(buf, host_ok, zb)
    assert _check_against_oracle(*folded)
    r_sc = list(folded[3])
    r_sc[4] += 1
    assert not _check_against_oracle(folded[0], folded[1], folded[2], r_sc,
                                     folded[4])


@pytest.fixture
def fresh_arena(monkeypatch):
    """Attribution runs K2's plain version on a process-wide CPU arena of
    the test's own."""
    monkeypatch.setattr(tverify, "_PUBKEY_CACHE", {})


def _verify(pks, msgs, sigs):
    ok, bitmap = rlc.verify_batch_rlc(pks, msgs, sigs, device="cpu")
    want = [len(s) == 64 and ref.verify(p, m, s)
            for p, m, s in zip(pks, msgs, sigs)]
    assert bitmap.tolist() == want and ok == all(want)
    return ok, bitmap


def test_all_valid_and_shared_keys_fold(fresh_arena):
    ok, bitmap = _verify(*_signed_batch(13, seed=1))
    assert ok and bitmap.all() and len(bitmap) == 13
    # 3 distinct keys across 20 lanes: A's side folds to 3 points
    pks, msgs, sigs = _signed_batch(20, seed=2, n_keys=3)
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    assert len(rlc.fold(buf, host_ok, bytes(16 * 20))[0]) == 3
    ok, bitmap = _verify(pks, msgs, sigs)
    assert ok and bitmap.all()


def _tamper(sig: bytes, byte: int, mask: int) -> bytes:
    bad = bytearray(sig)
    bad[byte] ^= mask
    return bytes(bad)


@pytest.mark.parametrize("case", ["single_invalid", "wrong_message",
                                  "undecodable_r", "malformed_lane",
                                  "noncanonical_s"])
def test_an_invalid_lane_is_attributed(fresh_arena, case):
    seed = {"single_invalid": 3, "wrong_message": 4, "undecodable_r": 5,
            "malformed_lane": 6, "noncanonical_s": 7}[case]
    pks, msgs, sigs = _signed_batch(9 if case == "single_invalid" else 8,
                                    seed=seed)
    bad = {"single_invalid": 4, "wrong_message": 0, "undecodable_r": 3,
           "malformed_lane": 2, "noncanonical_s": 1}[case]
    if case == "single_invalid":
        sigs[bad] = _tamper(sigs[bad], 2, 0x40)
    elif case == "wrong_message":
        msgs[bad] = b"tampered"
    elif case == "undecodable_r":
        sigs[bad] = _undecodable_y() + sigs[bad][32:]
    elif case == "malformed_lane":
        sigs[bad] = b"short"
    else:
        s = int.from_bytes(sigs[bad][32:], "little") + L
        sigs[bad] = sigs[bad][:32] + s.to_bytes(32, "little")
    ok, bitmap = _verify(pks, msgs, sigs)
    assert not ok and not bitmap[bad] and bitmap.sum() == len(pks) - 1


def test_empty_single_and_large_mixed_validity(fresh_arena):
    ok, bitmap = rlc.verify_batch_rlc([], [], [], device="cpu")
    assert ok and len(bitmap) == 0
    ok, bitmap = _verify(*_signed_batch(1, seed=8))
    assert ok and bitmap.all()
    pks, msgs, sigs = _signed_batch(40, seed=9, n_keys=5)
    for i in (7, 31):
        sigs[i] = _tamper(sigs[i], 40, 1)
    ok, bitmap = _verify(pks, msgs, sigs)
    assert not ok and bitmap.sum() == 38 and not bitmap[7] and not bitmap[31]


def test_zip215_corpus_verdicts():
    """Each class of the ZIP-215 corpus as a one-lane batch: the equation
    (the plain _rlc_kernel over every class at once, through
    torch.func.vmap) gives the class's verdict, and the native MSM agrees
    on each equation; a host-rejected S never reaches it."""
    eqs, expects = [], []
    for name, pk, msg, sig, expect in chip_smoke.zip215_corpus():
        buf, host_ok = tverify.pack_bytes([pk], [msg], [sig])
        if not host_ok[0]:
            assert rlc.verify_batch_rlc([pk], [msg], [sig],
                                        device="cpu") == (False, host_ok)
            assert not expect, name
            continue
        folded = rlc.fold(buf, host_ok, bytes(range(16)))
        res = host_batch._msm_identity(
            b"".join(folded[0] + folded[2] + [host_batch._B_ENC]),
            b"".join(s.to_bytes(32, "little")
                     for s in folded[1] + folded[3] + [folded[4]]), 3)
        assert (res == 1) == expect, name
        eqs.append(rlc.to_device(rlc.launch_inputs(*folded), "cpu"))
        expects.append(expect)
    assert len(eqs) == 30 and {(e["c_a"], e["c_r"]) for e in eqs} == {(4, 4)}
    keys = ("y_a", "sign_a", "plan_a", "y_r", "sign_r", "plan_r", "b_bytes")
    stacked = [tuple(torch.stack([e[k][i] for e in eqs]) for i in range(4))
               if k.startswith("plan") else torch.stack([e[k] for e in eqs])
               for k in keys]
    got = torch.func.vmap(lambda *a: rlc._rlc_kernel(*a, c_a=4, c_r=4))(
        *stacked)
    assert got.tolist() == expects


# --------------------------------------------- X5's source through g++


BAR = r"""
// __syncthreads() as a barrier of the whole block: a fiber waits until
// every thread arrived (the stub's own yields once, which is a barrier
// only where every thread yields as often before it)
namespace emu {
inline void bar_wait(int id, int n) {
  const int phase = phases[id];
  bar_arrive(id, n);
  for (long spins = 0; phases[id] == phase; ++spins) {
    if (spins > (1L << 22)) {
      failed = true;
      to_main(cur);
    }
    run_next(cur);
  }
}
}  // namespace emu
"""


@pytest.fixture(scope="module")
def x5(tmp_path_factory):
    fe26._gpp()
    source = BAR + (CSRC / "rlc.cu").read_text().replace(
        "__syncthreads()", "emu::bar_wait(0, (int)blockDim.x)")
    lib = fe26._compile(tmp_path_factory.mktemp("x5"), "rlc", source)
    fn = lib.x5_rlc_stage
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_x5(fn, inp, s, f=1):
    """X5's stages on the launch inputs ``inp`` with runs of ``s``
    buckets and groups of ``f`` runs: (window sums of A, of R, the
    pre-cofactor total, each as encodings; the output byte)."""
    c_a, c_r = inp["c_a"], inp["c_r"]
    na, nr = inp["y_a"].shape[1], inp["y_r"].shape[1]
    wa, wr = rlc.windows(c_a, 253), rlc.windows(c_r, 128)
    ma, mr = 1 << (c_a - 1), 1 << (c_r - 1)
    arrs = [inp["y_a"], inp["sign_a"], *inp["plan_a"], inp["y_r"],
            inp["sign_r"], *inp["plan_r"], inp["b_bytes"],
            curve.kernel_consts(),
            cuda_verify._base_table8_26(torch.device("cpu")).numpy()]
    arrs = [np.ascontiguousarray(a, dtype=np.int32) for a in arrs]
    sums = np.zeros((wa + wr + 2, 4, 10), np.uint32)
    out = np.full(1, 7, np.uint8)
    runs = wa * ma // s + wr * mr // s
    arrs += [np.zeros((na + nr, 3, 10), np.uint32),
             np.full(-(-(na + nr) // cuda_rlc.DECOMPRESS_BLOCK), 7, np.uint8),
             np.zeros((wa * ma + wr * mr, 4, 10), np.uint32),
             np.zeros((runs, 2, 4, 10), np.uint32),
             np.zeros((runs // f, 2, 4, 10), np.uint32), sums, out]
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    ints = (ctypes.c_int * 8)(na, c_a, wa, nr, c_r, wr, s, f)
    for stage in range(len(cuda_rlc.STAGES)):
        assert fn(ptrs, ints, stage, None) == 0
    encs = rlc.encode(sums.transpose(1, 2, 0).astype(np.int64), 26)
    return encs[:wa], encs[wa:wa + wr], encs[wa + wr:wa + wr + 1], int(out[0])


# runs of s buckets in groups of f runs, at buckets 8 (m = 8): two groups
# of two runs a window, one of two, one of four, and one run
X5_GROUPS = {"holds": 2, "b_plus_1": 2, "undecodable_r": 4,
             "undecodable_zero": 1}


@pytest.mark.parametrize("case,s", [("holds", 2),
                                    ("b_plus_1", 4),
                                    ("undecodable_r", 2),
                                    ("undecodable_zero", 8)])
def test_x5_source_equals_the_plain_version(x5, msm, case, s):
    """X5 under g++ at buckets 8 (A and R), with runs of s buckets in
    groups of X5_GROUPS[case] runs (8: one run a window; 2 and 4 exercise
    the groups' and the join's sums of segments): window sums and total by
    encoding, the byte as the plain bool (on "undecodable_zero" only the
    ok bytes can make it 0)."""
    cases, _, got = msm
    assert cuda_rlc.run_buckets(cases[case]["c_a"], cases[case]["c_r"]) == 8
    ws_a, ws_r, total, ok = got[case]
    enc_a, enc_r, enc_t, byte = run_x5(x5, cases[case], s, X5_GROUPS[case])
    assert enc_a == rlc.encode(ws_a)
    assert enc_r == rlc.encode(ws_r)
    assert enc_t == rlc.encode(total[:, :, None])
    assert byte == int(bool(ok))


def test_x5_source_on_seeded_lanes_at_buckets_8_and_16(x5):
    """A signed batch folded as verify_batch_rlc folds it (A at bucket 8,
    R at 16), then the same with one signature tampered."""
    pks, msgs, sigs = _signed_batch(13, seed=21, n_keys=3)
    for tampered in (False, True):
        if tampered:
            sigs[2] = _tamper(sigs[2], 40, 4)
        buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
        inp = rlc.launch_inputs(*rlc.fold(buf, host_ok, bytes(range(208))))
        assert (inp["y_a"].shape[1], inp["y_r"].shape[1]) == (8, 16)
        ws_a, ws_r, total, ok = rlc._rlc_parts(**rlc.to_device(inp, "cpu"))
        assert bool(ok) == (not tampered)
        enc_a, enc_r, enc_t, byte = run_x5(x5, inp, 8)
        assert (enc_a, enc_r, enc_t) == (rlc.encode(ws_a), rlc.encode(ws_r),
                                         rlc.encode(total[:, :, None]))
        assert byte == int(not tampered)


def _edge_side_case(name):
    """The folded inputs of an edge case for X5's source, and whether the
    equation holds: "long_segment", 13 R lanes of one scalar (bucket 3 of
    window 0 takes all 13 of them, its warp-mates none); "pads_identity",
    one real point a side and a real lane whose encoding is the
    identity's, of a nonzero scalar, among the pads; "undecodable_pad",
    an undecodable A point of a nonzero scalar among the pads, the sums
    holding without it (only the ok bit fails)."""
    rng = np.random.default_rng({"long_segment": 31, "pads_identity": 32,
                                 "undecodable_pad": 33}[name])

    def rand(bits):
        return int.from_bytes(rng.bytes(32), "little") % (1 << bits)

    ident = (1).to_bytes(32, "little")
    if name == "long_segment":
        xs, ys = [rand(252) for _ in range(5)], [rand(252) for _ in range(13)]
        a_sc, r_sc = [rand(252) % L for _ in xs], [3] * 13
        extra_a, extra_sc = [], []
    elif name == "pads_identity":
        xs, ys = [rand(252)], [rand(252)]
        a_sc, r_sc = [rand(252) % L], [max(1, rand(128))]
        extra_a, extra_sc = [ident], [rand(252) % L]
    else:
        xs, ys = [rand(252), rand(252)], [rand(252)]
        a_sc, r_sc = [rand(252) % L for _ in xs], [max(1, rand(128))]
        extra_a, extra_sc = [_undecodable_y()], [rand(252) % L]
    b = -(sum(a * x for a, x in zip(a_sc, xs))
          + sum(r * y for r, y in zip(r_sc, ys))) % L
    a_encs = [_point_enc(x) for x in xs] + extra_a
    r_encs = [_point_enc(y) for y in ys]
    return ((a_encs, a_sc + extra_sc, r_encs, r_sc, b),
            name != "undecodable_pad")


@pytest.mark.parametrize("case", ["long_segment", "pads_identity",
                                  "undecodable_pad"])
def test_x5_source_on_edge_sides(x5, case):
    """X5 under g++ where a warp's segments are far apart in length, where
    a side is mostly pads with a real identity-encoded lane among them
    (decoded without the sqrt chain), and where an undecodable lane sits
    among the pads: window sums and total by encoding against the plain
    version, the byte as its bool and the native MSM's verdict."""
    folded, holds = _edge_side_case(case)
    inp = rlc.launch_inputs(*folded)
    if case == "long_segment":
        starts, ends = inp["plan_r"][2], inp["plan_r"][3]
        lens = ends[0] - starts[0]
        assert lens[2] == 13 and lens.sum() == 13
    ws_a, ws_r, total, ok = rlc._rlc_parts(**rlc.to_device(inp, "cpu"))
    assert bool(ok) == holds
    assert (host_batch._msm_identity(
        b"".join(folded[0] + folded[2] + [host_batch._B_ENC]),
        b"".join(s.to_bytes(32, "little")
                 for s in folded[1] + folded[3] + [folded[4]]),
        len(folded[0]) + len(folded[2]) + 1) == 1) == holds
    enc_a, enc_r, enc_t, byte = run_x5(x5, inp, 2, 2)
    assert (enc_a, enc_r, enc_t) == (rlc.encode(ws_a), rlc.encode(ws_r),
                                     rlc.encode(total[:, :, None]))
    assert byte == int(holds)
