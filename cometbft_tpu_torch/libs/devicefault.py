"""Faults of the device path, marked where they leave it.

A caller that must tell a fault of the verify or hash plane (a kernel
that does not build or launch, a CUDA error, a stopped plane, a passed
deadline) from an error that its own input caused cannot tell them by
type: a ``RecursionError`` from a peer's nested JSON is a
``RuntimeError`` as much as a failed launch is. So the planes mark what
leaves them, and the exception keeps its type.

:func:`boundary` wraps a call into the device path (a batch verify, a
prestage) and marks whatever exception leaves it; :func:`mark` marks one
exception object (a window's fault, handed to every ticket of the
window). :func:`is_fault` says where a fault was marked, looking through
the exception's ``__cause__`` and ``__context__`` chain, or returns None
for an error the device path did not raise.
"""

from __future__ import annotations

import contextlib

_ATTR = "device_fault"


def mark(exc: BaseException, where: str) -> BaseException:
    """Mark ``exc`` as a fault of the device path raised in ``where``
    (an earlier mark stays). Returns ``exc``."""
    if getattr(exc, _ATTR, None) is None:
        setattr(exc, _ATTR, where)
    return exc


@contextlib.contextmanager
def boundary(where: str):
    """Mark any exception that leaves the block as a fault of ``where``."""
    try:
        yield
    except Exception as e:
        mark(e, where)
        raise


def is_fault(exc: BaseException | None) -> str | None:
    """Where the device path raised ``exc`` or an exception in its cause
    or context chain; None when it did not."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        where = getattr(exc, _ATTR, None)
        if where is not None:
            return where
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None
