"""Port field ops (cometbft_tpu_torch.ops.field) vs the JAX reference.

The same seeded numpy limbs go through cometbft_tpu.ops.field and its
torch counterpart; every op must return the same lazy limbs, limb for
limb (exact equality: the arithmetic is integer). Inputs are random limbs
under the lazy bound and limbs AT the bound (all 10015), where the int32
headroom is tightest.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import field as jfield
from cometbft_tpu_torch.ops import field as tfield

LAZY_BOUND = 10015
N = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _limbs(rng, bound_lanes):
    a = rng.integers(0, LAZY_BOUND + 1, size=(tfield.NLIMB, N), dtype=np.int32)
    a[:, :bound_lanes] = LAZY_BOUND
    return a


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20261016)
    return _limbs(rng, 3), _limbs(rng, 2)


def _both(fn_name, *arrays):
    j = np.asarray(getattr(jfield, fn_name)(*arrays))
    t = getattr(tfield, fn_name)(*(torch.from_numpy(a) for a in arrays))
    return j, t.numpy()


@pytest.mark.parametrize("op", ["mul", "add", "sub", "eq"])
def test_binary_ops_match_reference(inputs, op):
    a, b = inputs
    j, t = _both(op, a, b)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize(
    "op", ["sq", "neg", "dbl2", "canonical", "is_zero", "pow_2_252_m3"]
)
def test_unary_ops_match_reference(inputs, op):
    a, _ = inputs
    j, t = _both(op, a)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("passes", [1, 3])
def test_carry_matches_reference(inputs, passes):
    a, b = inputs
    raw = a * 3 + b  # unreduced limbs, as before a fold
    j = np.asarray(jfield.carry(raw, passes))
    t = tfield.carry(torch.from_numpy(raw), passes).numpy()
    np.testing.assert_array_equal(t, j)


def test_mul_lazy_bound_and_value(inputs):
    """Chained muls stay under the lazy bound and compute a*b mod p."""
    a, b = inputs
    x = torch.from_numpy(a)
    for _ in range(5):
        x = tfield.mul(x, torch.from_numpy(b))
    out = x.numpy()
    assert out.min() >= 0 and out.max() <= LAZY_BOUND
    for lane in range(N):
        av = tfield.from_limbs(a[:, lane])
        bv = tfield.from_limbs(b[:, lane])
        got = tfield.from_limbs(out[:, lane]) % tfield.P
        assert got == av * pow(bv, 5, tfield.P) % tfield.P


def test_canonical_edges_match_reference():
    """p, p-1, 2^255-1 and zero: the conditional subtract and the 2^255
    fold both fire."""
    vals = [0, 1, tfield.P - 1, tfield.P, tfield.P + 1, 2**255 - 1]
    arr = np.stack([tfield.to_limbs(v) for v in vals], axis=-1)
    j = np.asarray(jfield.canonical(arr))
    t = tfield.canonical(torch.from_numpy(arr)).numpy()
    np.testing.assert_array_equal(t, j)
    assert [tfield.from_limbs(c) for c in t.T] == [v % tfield.P for v in vals]
