"""Tracing / profiling helpers.

The reference's only instrumentation is a printf per detected frame
(reference: src/qpsk.c:196-200).  Here: jax.profiler trace capture,
recompilation logging (jit cache hygiene), and a simple throughput
meter for streaming loops.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

# Default trace directory: inside the checkout (listed in .gitignore).
TRACE_DIR = str(Path(__file__).resolve().parents[2] / "traces")


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR):
    """Capture a device trace viewable in TensorBoard/Perfetto."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def log_compiles():
    """Log every XLA compilation inside the block (recompile hygiene:
    a steady-state streaming loop must not retrace)."""
    import jax
    with jax.log_compiles():
        yield


@dataclass
class ThroughputMeter:
    """Samples/s meter for streaming demod loops."""
    samples: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, n_samples: int) -> None:
        self.samples += n_samples

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.elapsed, 1e-9)

    def summary(self, fs: float = 8000.0) -> dict:
        sps = self.samples_per_sec
        return {
            "samples": self.samples,
            "wall_s": round(self.elapsed, 4),
            "samples_per_sec": round(sps, 1),
            "realtime_channels": int(sps / fs),
        }
