"""Batch-verification dispatch: key type -> batch verifier backend.

Reference surface: crypto/crypto.go:45-54 (BatchVerifier interface) and
crypto/batch/batch.go:11-32 (CreateBatchVerifier / SupportsBatchVerifier).

The ed25519 backend accumulates (pubkey, msg, sig) triples on the host.
A batch at or above the host/device cut (:func:`host_batch_threshold`)
verifies in one device pass (ops/verify.verify_batch); a smaller one goes
to the pushed verify coalescer (crypto/coalesce.verify_bytes), where
concurrent small callers share windows, or with none pushed to the native
RLC host batch (crypto/host_batch.verify_many). That is routing, not a
rescue: a routed batch whose coalescer or kernel fails raises. What a
verifier's ``verify`` or :func:`prestage_validators` raises is marked as
the device path's fault (libs/devicefault): their inputs were checked at
``add``, and a malformed lane verifies False rather than raising.

sr25519 rides the same kernels: :class:`MixedBatchVerifier` verifies a
set of ed25519 and sr25519 keys as one batch, the sr25519 lanes' merlin
challenges and ristretto -> Edwards conversion computed on the host
(crypto/sr25519.py, in the native engine), all lanes packed into 128-byte
rows for ops/verify.verify_prepacked; :class:`Sr25519BatchVerifier` is
the same verifier restricted to sr25519 keys. It routes by the same cut:
below it the native host batch (host_batch.verify_quads), at or above it
the device.

Every verifier reports its batches to libs/metrics as the reference's
do (``crypto_verify_batch_seconds`` and ``_sigs_total`` by backend, and
its phases to ``crypto_verify_phase_seconds``).

:class:`AdaptiveCrossover` is the runtime host/device crossover fit: one
per device refines the verify cut from the batches and coalescer windows
it sees; the hash plane (crypto/hashplane.py) keeps one per SHA block
bucket.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..libs import devicefault
from ..libs import metrics as libmetrics
from ..libs import sync as libsync
from . import ed25519_ref, keys
from .keys import Ed25519PubKey

L = ed25519_ref.L


class BatchVerifier:
    """Add/Verify contract of crypto.BatchVerifier (crypto/crypto.go:45-54).

    ``verify`` returns (all_valid, per_signature_validity); per-lane results
    let callers name the failing signature without a second pass.
    """

    def add(self, pub_key, msg: bytes, signature: bytes) -> None:
        raise NotImplementedError

    def verify(self) -> tuple[bool, list[bool]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


# The seed of the host/device cut: batches of fewer signatures verify on
# the host (crypto/host_batch), larger ones on the device. Derived, first
# match wins, from
#   1. COMETBFT_TPU_HOST_THRESHOLD (an operator pin; it also turns
#      adaptation off), then
#   2. _DEFAULT_HOST_BATCH_THRESHOLD: the crossing of chip_smoke.py's vote
#      phase sweep (host_batch.verify_many against one coalescer-shaped
#      K2 window, pack + launch + readback, median of 5 each, at 8 to
#      2,048 lanes) on NVIDIA H100 80GB HBM3, 700.00 W: the card won
#      from the smallest swept count, 8 lanes (1.46 ms against 1.86).
# Nothing here reads a TPU's chip table.
_DEFAULT_HOST_BATCH_THRESHOLD = 8


def _derive_host_threshold() -> int:
    env = os.environ.get("COMETBFT_TPU_HOST_THRESHOLD")
    if env:
        try:
            return max(2, int(env))
        except ValueError:
            pass
    return _DEFAULT_HOST_BATCH_THRESHOLD


HOST_BATCH_THRESHOLD = _derive_host_threshold()
_ENV_PINNED = bool(os.environ.get("COMETBFT_TPU_HOST_THRESHOLD"))


class Ed25519BatchVerifier(BatchVerifier):
    """ed25519 batch verification, routed by size (see the module
    docstring). A batch at or above the cut runs on ``device`` (default the
    GPU).

    ``pubkey_cache`` (an ops.verify.PubkeyTableCache on the same device)
    routes the batch through the cached kernel; None takes the process-wide
    cache of the device (ops.verify.pubkey_cache), or with
    COMETBFT_TPU_PUBKEY_CACHE=0 the uncached kernel.
    ``flavor`` picks the kernels' flavor (ops.verify.kernel_flavor: "4",
    "8", or None for COMETBFT_TPU_KERNEL read when the batch verifies).
    """

    def __init__(self, device="cuda", pubkey_cache=None, flavor=None) -> None:
        self.device = device
        self.pubkey_cache = pubkey_cache
        self.flavor = flavor
        self._pubkeys: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, pub_key, msg: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, Ed25519PubKey):
            raise TypeError("Ed25519BatchVerifier requires ed25519 keys")
        self._pubkeys.append(pub_key.data)
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(signature))

    def __len__(self) -> int:
        return len(self._pubkeys)

    @devicefault.boundary("ed25519 batch verify")
    def verify(self) -> tuple[bool, list[bool]]:
        n = len(self._pubkeys)
        if n < host_batch_threshold(self.device):
            from . import coalesce, host_batch

            t0 = time.perf_counter()
            bits = coalesce.verify_bytes(self._pubkeys, self._msgs,
                                         self._sigs)
            if bits is not None:
                _observe("ed25519-coalesce", t0, n, self.device)
                return all(bits), list(bits)
            # no coalescer routed: the host batch, on a clock of its own
            t0 = time.perf_counter()
            bits = host_batch.verify_many(self._pubkeys, self._msgs,
                                          self._sigs)
            libmetrics.observe_verify_phase(
                "fallback", "ed25519-host", time.perf_counter() - t0, n)
            _observe("ed25519-host", t0, n, self.device)
            return all(bits), list(bits)
        from ..ops import verify as ov

        # the pack/dispatch/readback phases are observed inside
        # ops.verify.verify_batch
        t0 = time.perf_counter()
        ok_all, bitmap = ov.verify_batch(
            self._pubkeys, self._msgs, self._sigs,
            device=self.device, cache=self.pubkey_cache, flavor=self.flavor,
        )
        _observe("ed25519-tpu", t0, n, self.device)
        return ok_all, list(np.asarray(bitmap, bool))


class MixedBatchVerifier(BatchVerifier):
    """One verifier for a set of ed25519 and sr25519 lanes. Both schemes
    come down to the same 128-byte wire row A | R | S | (-k mod L) of
    Edwards encodings and differ only in the challenge (SHA-512 or a merlin
    transcript, both computed on the host), so a mixed batch is one device
    launch, or one host RLC MSM. The Go engine cannot batch a mixed set:
    its CreateBatchVerifier keys off one type and verifyCommitBatch falls
    back to single verifies (types/validation.go:170-176).

    Routed by size like :class:`Ed25519BatchVerifier`: below the cut the
    host RLC batch (host_batch.verify_quads), at or above it ``device``;
    ``pubkey_cache`` and ``flavor`` as there. The arena is keyed by the
    Edwards encoding, so a converted sr25519 key and an ed25519 key share
    it."""

    _KEY_TYPES = (keys.ED25519_KEY_TYPE, keys.SR25519_KEY_TYPE)
    _BACKEND = "mixed"  # the metrics' backend label: mixed-host, mixed-tpu

    def __init__(self, device="cuda", pubkey_cache=None, flavor=None) -> None:
        self.device = device
        self.pubkey_cache = pubkey_cache
        self.flavor = flavor
        self._types: list[str] = []
        self._pubkeys: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, pub_key, msg: bytes, signature: bytes) -> None:
        t = getattr(pub_key, "type", None)
        if t not in self._KEY_TYPES:
            raise TypeError(
                f"{type(self).__name__} cannot batch key type {t!r}")
        self._types.append(t)
        self._pubkeys.append(pub_key.data)
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(signature))

    def __len__(self) -> int:
        return len(self._pubkeys)

    def _pack_rows(self) -> tuple[np.ndarray, np.ndarray, list]:
        """(buf (128, n), host_ok, a_keys): the device wire rows, each
        scheme's lanes packed by ops/verify (ed25519 by pack_bytes, sr25519
        by pack_parts over crypto/sr25519.verification_encs_batch) and
        scattered into one buffer. a_keys are the lanes' Edwards A
        encodings, b"" where the host rejected the lane (a zero row)."""
        from ..ops import verify as ov
        from . import sr25519 as sr

        n = len(self._pubkeys)
        rows = np.zeros((n, 128), np.uint8)  # lane-major, one row a lane
        host_ok = np.zeros(n, bool)
        for kind in self._KEY_TYPES:
            idx = [i for i, t in enumerate(self._types) if t == kind]
            if not idx:
                continue
            lanes = [[col[i] for i in idx]
                     for col in (self._pubkeys, self._msgs, self._sigs)]
            if kind == keys.ED25519_KEY_TYPE:
                buf, ok = ov.pack_bytes(*lanes)
            else:
                buf, ok = ov.pack_parts(sr.verification_encs_batch(*lanes))
            rows[idx] = buf.T
            host_ok[idx] = ok
        blob = rows.tobytes()
        a_keys = [blob[128 * i : 128 * i + 32] if host_ok[i] else b""
                  for i in range(n)]
        return np.ascontiguousarray(rows.T), host_ok, a_keys

    def _quads(self) -> list:
        """Per-lane (A_enc, R_enc, s, k) read back from the wire rows, None
        for a lane rejected on the host: the host tier's input."""
        buf, host_ok, _ = self._pack_rows()
        blob = np.ascontiguousarray(buf.T).tobytes()
        quads: list = []
        for i in range(len(host_ok)):
            if not host_ok[i]:
                quads.append(None)
                continue
            row = blob[128 * i : 128 * i + 128]
            kneg = int.from_bytes(row[96:], "little")
            quads.append((row[:32], row[32:64],
                          int.from_bytes(row[64:96], "little"),
                          (L - kneg) % L))
        return quads

    @devicefault.boundary("mixed batch verify")
    def verify(self) -> tuple[bool, list[bool]]:
        from . import host_batch

        n = len(self._pubkeys)
        t0 = time.perf_counter()
        if n < host_batch_threshold(self.device):
            bits = host_batch.verify_quads(self._quads())
            libmetrics.observe_verify_phase(
                "fallback", self._BACKEND + "-host",
                time.perf_counter() - t0, n)
            _observe(self._BACKEND + "-host", t0, n, self.device)
            return all(bits), bits
        from ..ops import verify as ov

        backend = self._BACKEND + "-tpu"
        buf, host_ok, a_keys = self._pack_rows()
        t1 = time.perf_counter()
        libmetrics.observe_verify_phase("pack", backend, t1 - t0, n)
        done = ov.verify_prepacked(buf, a_keys, n, device=self.device,
                                   cache=self.pubkey_cache,
                                   flavor=self.flavor)
        t2 = time.perf_counter()
        libmetrics.observe_verify_phase("dispatch", backend, t2 - t1, n)
        device_ok = done()
        libmetrics.observe_verify_phase("readback", backend,
                                        time.perf_counter() - t2, n)
        valid = device_ok & host_ok
        _observe(backend, t0, n, self.device)
        return bool(valid.all()), list(np.asarray(valid, bool))


class Sr25519BatchVerifier(MixedBatchVerifier):
    """sr25519 batch verification on the ed25519 kernels (the reference's
    crypto/sr25519/batch.go:14-46): each lane's merlin challenge k and its
    points' Edwards encodings come from the host (crypto/sr25519.
    verification_encs_batch), and the cofactored equation [8](sB - kA - R)
    == O decides ristretto equality exactly. A :class:`MixedBatchVerifier`
    that takes sr25519 keys only."""

    _KEY_TYPES = (keys.SR25519_KEY_TYPE,)
    _BACKEND = "sr25519"


_BATCH_BACKENDS: dict[str, type] = {
    keys.ED25519_KEY_TYPE: Ed25519BatchVerifier,
    keys.SR25519_KEY_TYPE: Sr25519BatchVerifier,
}


@devicefault.boundary("prestage")
def prestage_validators(validator_set, device="cuda") -> int:
    """Warm the process-wide pubkey arena of ``device`` with a validator
    set's ed25519 keys (ops.verify.prestage_pubkeys: COMETBFT_TPU_PRESTAGE
    decides whether it runs), so its next commit runs the cached kernel
    with no X1 launch. Returns the X1 launches it took. sr25519
    keys are skipped, as the reference skips them: their arena key is the
    converted Edwards encoding, and the conversion is the costly host step,
    so the first batch that needs them builds them."""
    keys_bytes = [
        v.pub_key.data
        for v in getattr(validator_set, "validators", [])
        if getattr(v.pub_key, "type", None) == keys.ED25519_KEY_TYPE
    ]
    if not keys_bytes:
        return 0
    from ..ops import verify as ov

    return ov.prestage_pubkeys(keys_bytes, device=device)


def supports_batch_verifier(pub_key) -> bool:
    return getattr(pub_key, "type", None) in _BATCH_BACKENDS


def supports_commit_batch(validator_set) -> bool:
    """True when every key type in the set has a batch backend."""
    vals = getattr(validator_set, "validators", [])
    return bool(vals) and all(supports_batch_verifier(v.pub_key) for v in vals)


def create_batch_verifier(pub_key, device="cuda", pubkey_cache=None,
                          flavor=None) -> BatchVerifier:
    """The batch backend for ``pub_key``'s type; ValueError for types
    without one (callers verify singly, types/validation.go:170-176)."""
    backend = _BATCH_BACKENDS.get(getattr(pub_key, "type", None))
    if backend is None:
        raise ValueError(
            f"batch verification unsupported for key type "
            f"{getattr(pub_key, 'type', None)!r}"
        )
    return backend(device=device, pubkey_cache=pubkey_cache,
                   flavor=flavor)


def create_commit_batch_verifier(validator_set, device="cuda",
                                 pubkey_cache=None,
                                 flavor=None) -> BatchVerifier:
    """Batch verifier for a validator set: its scheme's own backend when
    every key has one type, :class:`MixedBatchVerifier` when the set mixes
    types that each have a backend (one launch where the Go engine verifies
    singly); ValueError otherwise (a secp256k1 key, an empty set)."""
    types = {
        getattr(v.pub_key, "type", None)
        for v in getattr(validator_set, "validators", [])
    }
    backend = _BATCH_BACKENDS.get(next(iter(types))) if len(types) == 1 else None
    if backend is None and types and all(t in _BATCH_BACKENDS
                                         for t in types):
        backend = MixedBatchVerifier
    if backend is None:
        raise ValueError(
            f"batch verification unsupported for key types {sorted(types)!r}"
        )
    return backend(device=device, pubkey_cache=pubkey_cache,
                   flavor=flavor)


class AdaptiveCrossover:
    """Runtime-calibrated host/device batch-size crossover.

    Both sides get the model ``time(n) = floor + slope * n``: the device
    floor is the launch cost that dominates small batches, the host floor
    a fixed per-call cost. Observations feed decayed least-squares
    accumulators; the crossover solves ``h_floor + h_rate * n = d_floor +
    d_slope * n`` and is clamped to [``lo``, HI] (``lo`` defaults to LO,
    the reference's floor). Until both sides have ``MIN_SAMPLES`` it
    answers None and the caller's seed holds.
    """

    DECAY = 0.98  # per-observation decay of the running moments
    MIN_SAMPLES = 5
    LO, HI = 64, 16384

    def __init__(self, lo: int = LO) -> None:
        self.lo = lo
        self._mtx = libsync.Mutex("crypto.batch._crossover")
        # decayed least-squares moments of (n, seconds) pairs per side
        self._host = [0.0, 0.0, 0.0, 0.0, 0.0]  # sw, sx, sy, sxx, sxy
        self._dev = [0.0, 0.0, 0.0, 0.0, 0.0]
        self._host_n = 0
        self._dev_n = 0

    def _accumulate(self, acc: list[float], n: int, seconds: float) -> None:
        d = self.DECAY
        acc[0] = d * acc[0] + 1.0
        acc[1] = d * acc[1] + n
        acc[2] = d * acc[2] + seconds
        acc[3] = d * acc[3] + float(n) * n
        acc[4] = d * acc[4] + n * seconds

    def observe_host(self, n: int, seconds: float) -> None:
        if n <= 0 or seconds <= 0:
            return
        with self._mtx:
            self._host_n += 1
            self._accumulate(self._host, n, seconds)

    def observe_device(self, n: int, seconds: float) -> None:
        if n <= 0 or seconds <= 0:
            return
        with self._mtx:
            self._dev_n += 1
            self._accumulate(self._dev, n, seconds)

    @staticmethod
    def _fit(acc: list[float]) -> tuple[float, float]:
        """(floor, slope) of time(n) = floor + slope*n from the decayed
        moments; samples at one size give a pure floor (slope 0)."""
        sw, sx, sy, sxx, sxy = acc
        mx = sx / sw
        my = sy / sw
        var = sxx / sw - mx * mx
        cov = sxy / sw - mx * my
        if var > 1e-9:
            slope = max(0.0, cov / var)
            floor = max(0.0, my - slope * mx)
        else:
            slope, floor = 0.0, my
        return floor, slope

    def fit_summary(self) -> dict:
        """The live fit: each side's floor (s), per-lane slope (s) and
        samples, and the solved crossover. A side's floor and slope are
        None while it has fewer than ``MIN_SAMPLES``."""
        with self._mtx:
            host_n, dev_n = self._host_n, self._dev_n
            h = self._fit(self._host) if host_n >= self.MIN_SAMPLES else None
            d = self._fit(self._dev) if dev_n >= self.MIN_SAMPLES else None
        return {
            "host_floor_s": h[0] if h else None,
            "host_rate_s_per_lane": h[1] if h else None,
            "host_samples": host_n,
            "device_floor_s": d[0] if d else None,
            "device_slope_s_per_lane": d[1] if d else None,
            "device_samples": dev_n,
            "crossover_lanes": self.threshold(),
        }

    def threshold(self) -> int | None:
        """The calibrated crossover, or None while uncalibrated."""
        with self._mtx:
            if (
                self._host_n < self.MIN_SAMPLES
                or self._dev_n < self.MIN_SAMPLES
                or self._host[0] <= 0
                or self._dev[0] <= 0
            ):
                return None
            h_floor, h_rate = self._fit(self._host)
            d_floor, d_slope = self._fit(self._dev)
        if h_rate <= d_slope:
            # past the floors the host wins at every size
            return self.HI
        n_star = (d_floor - h_floor) / (h_rate - d_slope)
        return int(min(self.HI, max(self.lo, n_star)))


def _adaptive_enabled(device="cuda") -> bool:
    """Whether a crossover on ``device`` adapts to what it observes:
    COMETBFT_TPU_ADAPTIVE_THRESHOLD=1 forces it, 0 turns it off, and
    otherwise it adapts on CUDA and keeps its seed on the CPU (so CPU runs
    route deterministically)."""
    mode = os.environ.get("COMETBFT_TPU_ADAPTIVE_THRESHOLD", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return torch.device(device).type == "cuda"


# The process-wide verify crossovers, one per device, made at first use
# (the reference's module-level CROSSOVER): batch verifiers and every
# coalescer on a device feed one fit. Its floor is 2 lanes, not the
# reference's 64: on the H100 one coalescer-shaped K2 window beats the host
# batch from the smallest swept window (8 lanes, chip_smoke.py's vote
# sweep), so a calibrated cut may settle below 64.
_VERIFY_CUT_FLOOR = 2
_CROSSOVERS: dict[torch.device, AdaptiveCrossover] = {}
_CROSSOVERS_LOCK = threading.Lock()


def crossover(device="cuda") -> AdaptiveCrossover:
    """The process-wide verify :class:`AdaptiveCrossover` of ``device``
    (raises for CUDA without a GPU)."""
    from ..ops.verify import resolve_device

    dev = resolve_device(device)
    with _CROSSOVERS_LOCK:
        xo = _CROSSOVERS.get(dev)
        if xo is None:
            xo = _CROSSOVERS[dev] = AdaptiveCrossover(lo=_VERIFY_CUT_FLOOR)
        return xo


def _verify_adaptive(device) -> bool:
    """Adaptation of the verify cut: off under a COMETBFT_TPU_HOST_THRESHOLD
    pin, else as :func:`_adaptive_enabled`."""
    return not _ENV_PINNED and _adaptive_enabled(device)


def host_batch_threshold(device="cuda") -> int:
    """The live host/device cut of ``device``: the calibrated crossover
    once it has samples of both sides and adaptation is on, else the seed
    :data:`HOST_BATCH_THRESHOLD`."""
    base = HOST_BATCH_THRESHOLD
    if not _verify_adaptive(device):
        return base
    t = crossover(device).threshold()
    return base if t is None else t


def note_device_window(n: int, seconds: float, device="cuda") -> None:
    """Feed the crossover of ``device`` a device batch or window."""
    if _verify_adaptive(device):
        crossover(device).observe_device(n, seconds)


def note_host_window(n: int, seconds: float, device="cuda") -> None:
    """Feed the crossover of ``device`` a host batch or window."""
    if _verify_adaptive(device):
        crossover(device).observe_host(n, seconds)


def _observe(backend: str, t0: float, n: int, device="cuda") -> None:
    """A batch's end-to-end latency and size since ``t0`` into the node
    metrics (``crypto_verify_batch_seconds``,
    ``crypto_verify_batch_sigs_total``), labelled by backend as the
    reference labels it ("-tpu" is the device route). ed25519 host and
    device batches also feed the crossover of ``device``: its linear fit
    is for one kernel's cost, so sr25519 and mixed samples stay out."""
    dt = time.perf_counter() - t0
    m = libmetrics.node_metrics()
    m.verify_batch_seconds.labels(backend).observe(dt)
    m.verify_batch_sigs.labels(backend).inc(n)
    if backend == "ed25519-host":
        note_host_window(n, dt, device)
    elif backend == "ed25519-tpu":
        note_device_window(n, dt, device)
