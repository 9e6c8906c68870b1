"""Env-gated crash points for fault-injection testing.

Reference: libs/fail/fail.go:28 + the FAIL_TEST_INDEX callsites at
state/execution.go:247-297 and consensus/state.go:1753-1820. Crash tests
spawn a real node process with ``COMETBFT_TPU_FAIL=<point-name>``; when
execution reaches that named point the process dies HARD (os._exit — no
cleanup, no flushes beyond what the code already fsynced), and the test
restarts the node asserting WAL/handshake recovery.

Points are free when the env var is unset: one dict lookup.
"""

from __future__ import annotations

import os
import sys

ENV_VAR = "COMETBFT_TPU_FAIL"

_target = os.environ.get(ENV_VAR, "")
_handler = None


def fail_point(name: str) -> None:
    """Die hard if this named point is the injection target."""
    if _target and name == _target:
        if _handler is not None:
            # In-process crash simulation (the simnet scenario engine):
            # the handler either raises — "this node just died" without
            # taking down the whole multi-node process — or returns to
            # skip (e.g. the armed point belongs to a different sim
            # node). Subprocess tests keep the os._exit semantics.
            _handler(name)
            return
        sys.stderr.write(f"FAIL POINT HIT: {name} — crashing\n")
        sys.stderr.flush()
        os._exit(99)


def set_target(name: str) -> None:
    """Test helper: arm a point in-process (subprocess tests use the env)."""
    global _target
    _target = name


def set_handler(fn) -> None:
    """Install (or clear, with None) the in-process crash handler used
    by simnet scenarios; see :func:`fail_point`."""
    global _handler
    _handler = fn


# -- delay points (gray-failure injection) ------------------------------
#
# Crash points model fail-stop; DELAY points model slow-but-alive — the
# gray failures (a disk whose fsync takes 200 ms, a store write stuck
# behind a saturated volume) that kill production clusters without ever
# tripping a liveness check.  A delay point is free when no handler is
# installed: one global read.  The simnet scenario engine installs a
# handler that charges VIRTUAL latency to the current sim node (on the
# sim clock, deterministic); live fault-injection tests may install one
# that really sleeps.

_delay_handler = None


def delay_point(name: str) -> None:
    """Charge the injected latency for this named point, if armed."""
    if _delay_handler is not None:
        _delay_handler(name)


def set_delay_handler(fn) -> None:
    """Install (or clear, with None) the slow-path handler used by the
    simnet slow-disk injection; see :func:`delay_point`."""
    global _delay_handler
    _delay_handler = fn
