"""Device-mesh sharding for validator-scale signature batches.

Two sharding axes, as in the JAX package's mesh:

* ``commit`` — independent commits verified concurrently (light-client
  replay over many heights, blocksync catch-up windows); no cross-shard
  traffic at all.
* ``sig`` — signatures within one commit (one lane per validator). The
  only cross-shard value is each commit's verdict, one bool.

A :class:`Mesh` is a (commit, sig) grid of ``torch.device``s. There is no
SPMD compiler here: :func:`verify_sharded` copies each grid entry's
(C_l, V_l) block of the host-packed arrays to that entry's device,
flattens it to lanes and launches K1 there (ops/cuda_verify.verify_kernel;
on a CPU device its plain version). Every launch is issued before any
readback, so the devices overlap; each device is synchronised before its
verdicts are read, and the per-commit verdict is an AND on the host, the
counterpart of the one-byte all-reduce of the JAX package's ``jnp.all``.

A grid may name one device more than once, as XLA's virtual host devices
let one host play eight: the CPU tests use ``["cpu"] * 8`` and a one-card
machine ``["cuda:0"] * 4``. Each shard takes K1 at its own lane count,
whatever it is: K1 has no block rule, so shards are not padded to 512
lanes as the Pallas kernel's are, and a failed launch on any shard raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..libs import accel as libaccel
from ..libs import devstats as libdevstats
from ..ops import cuda_verify

AXIS_COMMIT = "commit"
AXIS_SIG = "sig"

# K1's arguments, in its order
_ARGS = ("y_a", "sign_a", "y_r", "sign_r", "s_nibs", "kneg_nibs")


class Mesh:
    """A (commit, sig) grid of devices: ``devices`` is a 2-D object array
    of ``torch.device``, ``axis_names`` ("commit", "sig")."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = (AXIS_COMMIT, AXIS_SIG)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(devices=None, commit_axis: int = 1) -> Mesh:
    """Build a (commit, sig) mesh over ``devices`` (default: every CUDA
    device).

    ``commit_axis`` devices go to the commit axis, the rest to the
    signature axis; with the default 1 the whole mesh shards one commit's
    signatures, the consensus hot-path layout.
    """
    from ..ops.verify import resolve_device

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(libaccel.cuda_device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device")
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n % commit_axis != 0:
        raise ValueError(f"{n} devices not divisible by commit_axis={commit_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(commit_axis, n // commit_axis))


def pad_to(n: int, multiple: int) -> int:
    return (n + multiple - 1) // multiple * multiple


@lru_cache(maxsize=None)
def default_mesh() -> Mesh:
    """Process-wide (1, n_devices) mesh: one commit, every CUDA device on
    the signature axis. Cached so the production dispatch
    (ops/verify.verify_batch) builds it once."""
    return make_mesh(commit_axis=1)


def _dispatch_sharded(mesh: Mesh, args: dict):
    """K1 on each grid entry's block of ``args`` ((..., C, V) arrays, both
    axes divisible by the mesh's): ((C, V) bool, (C,) per-commit verdict)
    as numpy arrays."""
    c_dev, v_dev = mesh.devices.shape
    n_c, n_v = args["y_a"].shape[-2:]
    c_l, v_l = n_c // c_dev, n_v // v_dev
    launched = []
    for c in range(c_dev):
        for v in range(v_dev):
            dev = mesh.devices[c, v]
            blocks = [
                np.ascontiguousarray(
                    args[k][..., c * c_l:(c + 1) * c_l, v * v_l:(v + 1) * v_l]
                ).reshape(*args[k].shape[:-2], c_l * v_l)
                for k in _ARGS
            ]
            # each shard's copies and launch on its device's current stream
            tensors = [torch.from_numpy(b).to(dev) for b in blocks]
            libdevstats.record_h2d(sum(b.nbytes for b in blocks))
            ok = cuda_verify.verify_kernel(*tensors)
            launched.append((c, v, ok))
    for dev in {ok.device for _, _, ok in launched}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = np.empty((n_c, n_v), bool)
    for c, v, ok in launched:
        host = ok.cpu().numpy()
        libdevstats.record_d2h(host.nbytes)
        out[c * c_l:(c + 1) * c_l, v * v_l:(v + 1) * v_l] = host.reshape(
            c_l, v_l)
    return out, out.all(axis=-1)


def verify_sharded(
    arrays: dict,
    host_ok: np.ndarray,
    mesh: Mesh,
    n_commits: int,
    n_sigs: int,
):
    """Run the sharded verifier over host-packed arrays (ops.verify.
    pack_inputs) with trailing batch dim n_commits * n_sigs: the arrays
    are reshaped to (..., C, V), zero-padded so both mesh axes divide
    their dims, and dispatched; the padding lanes are sliced off the
    result. ``host_ok`` must be ANDed in: a lane the host rejected
    (malformed length, non-canonical S) is zeroed in ``arrays``, and the
    all-zero encoding decompresses to a small-order point that the
    cofactored check accepts, so without the mask it is a false accept.

    Returns ok (n_commits, n_sigs) bool ndarray.
    """
    c_dev, v_dev = mesh.devices.shape
    cp = pad_to(n_commits, c_dev)
    vp = pad_to(n_sigs, v_dev)
    shaped = {}
    for k in _ARGS:
        v = arrays[k]
        v = v.reshape(*v.shape[:-1], n_commits, n_sigs)
        pad = [(0, 0)] * (v.ndim - 2) + [(0, cp - n_commits), (0, vp - n_sigs)]
        shaped[k] = np.pad(v, pad)
    ok, _ = _dispatch_sharded(mesh, shaped)
    device_ok = ok[:n_commits, :n_sigs]
    return device_ok & np.asarray(host_ok, bool).reshape(n_commits, n_sigs)
