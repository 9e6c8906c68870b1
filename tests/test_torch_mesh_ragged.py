"""The port's verify_sharded vs the JAX package's on a ragged batch, on
the CPU: 3 commits x 5 signatures do not divide the (2, 4) mesh, so both
axes pad (to 4 x 8) and the padding is sliced off. Kept apart from
test_torch_mesh.py because this shape costs the reference a cold XLA
compile of its own (~24 s on a CPU); the helpers are that file's.
"""

import numpy as np
import pytest
import torch

import jax

from cometbft_tpu.parallel import mesh as jmesh
from cometbft_tpu_torch.parallel import mesh as tmesh
from test_torch_mesh import _both_sharded


@pytest.fixture(scope="module")
def ragged():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    meshes = (jmesh.make_mesh(jax.devices()[:8], commit_axis=2),
              tmesh.make_mesh(["cpu"] * 8, commit_axis=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _both_sharded(meshes, 3, 5, corrupt={6}, s_plus_l={12})
    finally:
        torch.set_num_threads(threads)


def test_ragged_matches_the_reference(ragged):
    """Bit-identical to the reference's verify_sharded and to the oracle."""
    ours, theirs, oracle, _ = ragged
    assert ours.dtype == bool and ours.shape == (3, 5)
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, oracle)


def test_ragged_names_the_bad_lanes(ragged):
    """The corrupt lane and the host-rejected one (S + L), nothing else."""
    assert np.flatnonzero(~ragged[0].ravel()).tolist() == [6, 12]


def test_ragged_launches_k1_once_a_mesh_entry(ragged):
    """4 x 8 padded lanes on (2, 4): eight launches of 2 x 2 lanes, with no
    512-lane padding."""
    assert ragged[3] == [(4, "cpu")] * 8
