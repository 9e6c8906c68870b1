"""Flow-rate monitoring and throttling (reference: libs/flowrate/flowrate.go).

Port of cometbft_tpu/libs/flowrate.py, line for line.

``Monitor`` tracks transfer rate with an EMA; ``limit`` returns how many
bytes may be sent now to honor a bytes/sec cap, sleeping like the
reference's blocking mode when the budget is exhausted.
"""

from __future__ import annotations

from . import sync as libsync
import time


class Monitor:
    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._mtx = libsync.Mutex("libs.flowrate._mtx")
        self._start = time.monotonic()
        self._total = 0
        self._rate_ema = 0.0
        self._window = window
        self._last_sample = self._start
        self._sample_bytes = 0

    def update(self, n: int) -> None:
        with self._mtx:
            now = time.monotonic()
            self._total += n
            self._sample_bytes += n
            dt = now - self._last_sample
            if dt >= 0.1:
                rate = self._sample_bytes / dt
                alpha = min(1.0, dt / self._window)
                self._rate_ema += alpha * (rate - self._rate_ema)
                self._sample_bytes = 0
                self._last_sample = now

    def rate(self) -> float:
        with self._mtx:
            return self._rate_ema

    def total(self) -> int:
        with self._mtx:
            return self._total

    def limit(self, want: int, rate_limit: int) -> int:
        """Bytes allowed now under ``rate_limit`` B/s; sleeps briefly when
        over budget (flowrate.go Limit in blocking mode)."""
        if rate_limit <= 0:
            return want
        while True:
            with self._mtx:
                now = time.monotonic()
                elapsed = max(now - self._start, 1e-9)
                budget = rate_limit * elapsed - self._total
            if budget > 0:
                return max(1, min(want, int(budget)))
            time.sleep(min(0.05, -budget / rate_limit))
