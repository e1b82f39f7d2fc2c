"""Production ingest: file/ring -> host dispatch buffers -> async H2D.

The reference's ingest is a single-channel blocking fread loop
(reference: src/qpsk.c:436-458).  Feeding the batch receiver at
hundreds of thousands of channels needs a pipeline:

  mmap'd PCM (native/scio.cc)  ->  blocked deinterleave (native)
      ->  [B, C, frame_size] int16 dispatch buffer (host)
      ->  jax.device_put overlapped with the PREVIOUS dispatch's
          compute (double buffering)  ->  prod_rx_batch.

Two host-side assembly modes, both backed by the native engine:

  * "deinterleave" (default): one blocked ``scio_deinterleave`` per
    time-block turns the ADC-natural sample-major [frame, C] stream
    into the receiver's channel-major rows.  This is the bulk path --
    the blocked transpose runs at memory speed where the ring's
    per-sample framing loop would touch C cache lines per sample.
  * "ring": samples flow through the lock-free SPSC ``FrameRing``
    exactly as a live capture thread would push them.  Kept as the
    real-time structure demonstration; for large C prefer
    "deinterleave".

``PrefetchIngest`` runs assembly on a producer thread with a bounded
queue so file IO + transpose overlap both the H2D copy and the device
compute; ``feed()`` is the double-buffered driver loop.  Measured by
tools/ingest_bench.py, which reports the end-to-end rate and the
host-assembly and device-compute rates that bound it separately.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from .engine import FrameRing, PcmFile, deinterleave


class PcmDispatchSource:
    """Interleaved int16 PCM file -> [B, C, frame_size] dispatch
    buffers.

    The file holds sample-major frames: sample s of channel c lives at
    ``(s*C + c)``.  ``loop=True`` wraps past EOF (steady-state
    throughput measurement from a bounded fixture file).
    """

    def __init__(self, path: str, channels: int, frame_size: int,
                 blocks_per_dispatch: int, *, loop: bool = False,
                 mode: str = "deinterleave", ring_capacity: int = 4,
                 workers: int = 1):
        if mode not in ("deinterleave", "ring"):
            raise ValueError(f"unknown ingest mode {mode!r}")
        self.file = PcmFile(path)
        self.C = channels
        self.n = frame_size
        self.B = blocks_per_dispatch
        self.loop = loop
        self.mode = mode
        self._off = 0
        self._total = self.file.n_samples
        self._block_samples = channels * frame_size
        if self._total < self._block_samples:
            raise ValueError(
                f"file holds {self._total} samples < one "
                f"[{channels} x {frame_size}] block")
        self._ring = (FrameRing(channels, frame_size,
                                capacity_blocks=ring_capacity)
                      if mode == "ring" else None)
        # Parallel assembly: the blocked deinterleave is one ctypes
        # call per time-block, and ctypes releases the GIL, so a
        # thread pool scales it across cores.
        self._pool = None
        if workers > 1 and mode == "deinterleave":
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=workers)

    def _read_block_interleaved(self) -> np.ndarray:
        """Next [frame_size * C] interleaved samples (wrapping)."""
        if self._off + self._block_samples > self._total:
            if not self.loop:
                raise EOFError("stream exhausted")
            self._off = 0
        out = self.file.read(self._off, self._block_samples)
        self._off += self._block_samples
        return out

    def read_dispatch(self, out: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """Assemble one [B, C, frame_size] int16 dispatch buffer."""
        if out is None:
            out = np.empty((self.B, self.C, self.n), np.int16)
        if self._pool is not None:
            raws = [self._read_block_interleaved()
                    for _ in range(self.B)]

            def one(b):
                from .engine import _ptr, load_library
                load_library().scio_deinterleave(
                    _ptr(raws[b]), _ptr(out[b]), self.n, self.C)
            list(self._pool.map(one, range(self.B)))
            return out
        for b in range(self.B):
            raw = self._read_block_interleaved()
            if self.mode == "deinterleave":
                out[b] = deinterleave(raw, self.C)
            else:
                pushed = self._ring.push(
                    raw.reshape(self.n, self.C))
                assert pushed == self.n, (pushed, self.n)
                blk = self._ring.pop()
                assert blk is not None
                out[b] = blk
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
        if self._ring is not None:
            self._ring.close()
        self.file.close()


class PrefetchIngest:
    """Producer-thread wrapper: assembles dispatch buffers ahead of the
    consumer so host IO/transpose overlaps H2D + compute.

    ``depth`` bounds the producer's lead; ``inflight`` is how many
    PREVIOUSLY-yielded buffers stay quarantined before recycling --
    ``jax.device_put`` may alias or still be streaming the host memory
    of the last couple of dispatches (zero-copy on CPU, async staging
    through PJRT), so a buffer is only returned to the free list after
    ``inflight`` newer buffers have been yielded (an immediate free
    let the producer overwrite samples the device was still reading).  Host memory: depth + inflight + 1 buffers;
    steady state allocates nothing.
    """

    def __init__(self, source: PcmDispatchSource, n_dispatches: int,
                 *, depth: int = 2, inflight: int = 2):
        self.source = source
        self.n = n_dispatches
        self.inflight = inflight
        self._ready: queue.Queue = queue.Queue(maxsize=depth)
        self._free: queue.Queue = queue.Queue()
        for _ in range(depth + inflight + 1):
            self._free.put(np.empty(
                (source.B, source.C, source.n), np.int16))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for _ in range(self.n):
                buf = self._free.get()
                self.source.read_dispatch(out=buf)
                self._ready.put(buf)
        except BaseException as e:   # surfaced on the consumer side
            self._err = e
            self._ready.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        from collections import deque
        held: deque = deque()
        for _ in range(self.n):
            buf = self._ready.get()
            if buf is None:
                raise RuntimeError("ingest producer failed") \
                    from self._err
            yield buf
            held.append(buf)
            if len(held) > self.inflight:
                self._free.put(held.popleft())


def feed(ingest: PrefetchIngest, put: Callable, step: Callable,
         state):
    """Double-buffered drive loop: H2D of dispatch k+1 overlaps the
    device compute of dispatch k.

    ``put(np_buf) -> device_array`` (typically ``jax.device_put`` of
    the [B, C, frame_size] buffer); ``step(state, dev) -> (state,
    chk)`` must be an ASYNC-dispatching jitted call.  Returns (state,
    last chk) -- the caller syncs once (``jax.block_until_ready``)
    after the loop.
    """
    it = iter(ingest)
    try:
        nxt = put(next(it))
    except StopIteration:
        return state, None
    chk = None
    while True:
        dev, nxt = nxt, None
        state, chk = step(state, dev)    # async on-device
        try:
            host_next = next(it)         # overlaps device compute
        except StopIteration:
            break
        nxt = put(host_next)             # H2D while the device computes
    return state, chk
