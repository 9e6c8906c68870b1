"""X1, the pubkey-arena builder (csrc/build_tables.cu), on the CPU.

Where g++ is on the path, X1's source compiles against the fiber stub of
tests/test_torch_fe26.py (every thread of a block a fiber that yields at
each __shfl_sync and __syncthreads) and runs on seeded keys and the
ZIP-215 classes of A: y = p + k with either sign, negative zero, the
identity as y = 1 + p, small-order and off-curve points, y = 2^255 - 1.
Its tables and ok bits must equal the reference's
cometbft_tpu.ops.curve.build_pubkey_tables limb for limb, and the port's
plain version, at ragged lane counts (the last block of 32 lanes part
empty). The table is a lazy 13-bit representation: a reordered or fused
op, an operand from the wrong thread of a quad, or a decompression that
flips the sign in another radix changes limbs, not values.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import test_torch_fe26 as fe26
from cometbft_tpu.ops import curve as jcurve
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import curve
from cometbft_tpu_torch.ops.build import CSRC

P = 2**255 - 19


def _encodings():
    encs = [ref.pubkey_from_seed(bytes([7, i]) * 16) for i in range(20)]
    encs += [((P + k) | (s << 255)).to_bytes(32, "little")
             for k in range(19) for s in (0, 1)]
    encs += [
        (1 | 1 << 255).to_bytes(32, "little"),  # negative zero
        (1 + P).to_bytes(32, "little"),  # the identity as y = 1 + p
        ref.compress(chip_smoke._order8_point(ref)),  # order 8
        (2).to_bytes(32, "little"),  # off the curve
        (2 | 1 << 255).to_bytes(32, "little"),
        (2**255 - 1).to_bytes(32, "little"),
        (2**256 - 1).to_bytes(32, "little"),
        # y does not decode, and its x's parity flip leaves other table
        # limbs in 26-bit limbs than in the reference's (about 1 lane in
        # 60,000 of random encodings does)
        (0xF83C00843F5FE45B3E9A171DC3B8BE831A0ED1D67B71D0FBE77DC934042B00D7
         ).to_bytes(32, "little"),
    ]
    return encs


def _limbs(encs):
    """(y_a (20, N), sign_a (N,)) int32 as the wire unpacks them."""
    ys = [int.from_bytes(e, "little") for e in encs]
    y_a = np.array([[(y >> (13 * i)) & 8191 for y in ys] for i in range(20)],
                   np.int32)
    y_a[19] &= 255
    return y_a, np.array([y >> 255 for y in ys], np.int32)


@pytest.fixture(scope="module")
def lanes():
    y_a, sign_a = _limbs(_encodings())
    table, ok = jcurve.build_pubkey_tables(jnp.asarray(y_a),
                                           jnp.asarray(sign_a))
    return y_a, sign_a, np.asarray(table), np.asarray(ok)


@pytest.fixture(scope="module")
def x1(tmp_path_factory):
    fe26._gpp()
    lib = fe26._compile(tmp_path_factory.mktemp("x1"), "build_tables",
                        (CSRC / "build_tables.cu").read_text())
    fn = lib.ed25519_build_tables
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_x1(fn, y_a, sign_a):
    n = y_a.shape[1]
    y_a, sign_a = np.ascontiguousarray(y_a), np.ascontiguousarray(sign_a)
    consts = np.ascontiguousarray(curve.kernel_consts())
    table = np.full((16, 4, 20, n), -1, np.int32)
    ok = np.full(n, 7, np.uint8)
    ptrs = [a.ctypes.data for a in (y_a, sign_a, consts, table, ok)]
    assert fn(*ptrs, n, None) == 0
    return table, ok


@pytest.mark.parametrize("n", [1, 9, 66])
def test_x1_source_writes_the_reference_arena(x1, lanes, n):
    """X1 under g++ on the first n lanes (66: every class; 9 and 1: a
    block of one or two quads' worth past N), limb for limb against the
    reference and the port's plain version; nothing written past N."""
    y_a, sign_a, want_table, want_ok = lanes
    assert y_a.shape[1] == 66 and 0 < want_ok.sum() < 66
    y_a, sign_a = y_a[:, :n], sign_a[:n]
    table, ok = run_x1(x1, y_a, sign_a)
    np.testing.assert_array_equal(table, want_table[..., :n])
    np.testing.assert_array_equal(ok.astype(bool), want_ok[:n])
    plain, plain_ok = curve.build_pubkey_tables(torch.from_numpy(y_a),
                                                torch.from_numpy(sign_a))
    np.testing.assert_array_equal(table, plain.numpy())
    np.testing.assert_array_equal(ok.astype(bool), plain_ok.numpy())
