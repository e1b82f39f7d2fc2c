"""Streaming block driver.

The reference's driver is a blocking fread/demod/fwrite loop over
1880-sample chunks (reference: src/qpsk.c:436-458).  This
driver is state-in/state-out over [channels, frame_size] blocks: the
host (or the native IO engine, native/scio.cc) feeds int16 blocks, the
jitted batched RX consumes them, and the per-channel state pytree rides
on device between calls -- nothing is re-transferred except the PCM in
and the decoded bits out.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import jax
import numpy as np

from ..config import ModemConfig
from ..modem.rx_production import ProdRxOut, prod_rx_init, prod_rx_frame
from .metrics import MetricsAggregator


class StreamDemodulator:
    """Stateful batched demodulator over a stream of PCM blocks.

    Replaces the reference main RX loop (qpsk.c:436-458).  Example::

        demod = StreamDemodulator(cfg, n_channels=4096)
        for block in blocks:                # [n_channels, frame_size] int16
            out = demod.push(block)
            packets = demod.collect_packets(out)
    """

    def __init__(self, cfg: ModemConfig, n_channels: int, *,
                 descramble: bool = True, metrics: bool = True,
                 validate: bool = False):
        self.cfg = cfg
        self.n_channels = n_channels
        self.validate = validate
        self.state = prod_rx_init(cfg, (n_channels,))
        self._step = jax.jit(jax.vmap(
            lambda st, pcm: prod_rx_frame(cfg, st, pcm,
                                          descramble=descramble)))
        self.metrics: Optional[MetricsAggregator] = (
            MetricsAggregator() if metrics else None)
        self.blocks_processed = 0

    def push(self, pcm_block) -> ProdRxOut:
        """Demodulate one [n_channels, frame_size] block."""
        if pcm_block.shape != (self.n_channels, self.cfg.frame_size):
            raise ValueError(
                f"expected {(self.n_channels, self.cfg.frame_size)}, "
                f"got {pcm_block.shape}")
        if self.validate:
            from .validate import assert_pcm_block, assert_rx_state
            assert_pcm_block(self.cfg, pcm_block, self.n_channels)
            assert_rx_state(self.cfg, self.state, self.n_channels)
        self.state, out = self._step(self.state, pcm_block)
        self.blocks_processed += 1
        if self.metrics is not None:
            self.metrics.update(out)
        return out

    def run(self, blocks: Iterable) -> Iterator[ProdRxOut]:
        for block in blocks:
            yield self.push(block)

    @staticmethod
    def collect_packets(out: ProdRxOut):
        """(channel, bits) pairs for every detected packet in a block."""
        valid = np.asarray(out.valid)
        bits = np.asarray(out.bits)
        return [(int(c), bits[c]) for c in np.nonzero(valid)[0]]

    def flush(self) -> ProdRxOut:
        """Feed one silent block so the 1-block hunt latency drains."""
        silent = np.zeros((self.n_channels, self.cfg.frame_size), np.int16)
        return self.push(silent)
