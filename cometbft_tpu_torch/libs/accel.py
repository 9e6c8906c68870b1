"""Process-wide accelerator probe.

One answer to "does this process have a CUDA device?", shared by the
gates that route work to the card (the sharded verify route in
ops/verify) so they cannot disagree within a process.

:func:`accelerator_backend` asks torch once: ``torch.cuda.is_available()``
and ``torch.cuda.device_count()``, cached for the life of the process.
Neither call creates a CUDA context. :func:`accelerator_backend_live`
answers without any CUDA call at all: True only once CUDA has been
initialised in this process (``torch.cuda.is_initialized()``), so a
metrics scrape or a steady-state gate never brings the card up.

The port reads no variable of its own to pin itself to the host: CUDA's
``CUDA_VISIBLE_DEVICES`` (an empty value hides every card, and torch then
reports none) is the one that does, and entry points take ``device="cpu"``
per call. ``JAX_PLATFORMS`` means nothing here.
"""

from __future__ import annotations

import threading

import torch

_probe: tuple[bool, int] | None = None
_lock = threading.Lock()


def _probed() -> tuple[bool, int]:
    global _probe
    with _lock:
        if _probe is None:
            available = torch.cuda.is_available()
            _probe = (available, torch.cuda.device_count() if available else 0)
        return _probe


def accelerator_backend() -> bool:
    """True when a CUDA device is available (probed once, cached)."""
    return _probed()[0]


def cuda_device_count() -> int:
    """CUDA devices this process can use (probed once, cached); 0 without
    CUDA."""
    return _probed()[1]


def accelerator_backend_live() -> bool:
    """True when CUDA is ALREADY initialised in this process. Never
    initialises it, so it is safe on hot paths and in a scrape."""
    return torch.cuda.is_initialized()
