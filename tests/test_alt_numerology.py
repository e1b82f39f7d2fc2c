"""End-to-end decode at a NON-default numerology.

Every constant the reference hardcodes is a ModemConfig field; this
pins that the whole pipeline -- TX, the scan oracle, and the batch
core (band matrices, tile padding, packet extraction) -- is generic
over it, not silently specialized to the 8 kHz / 1600 baud / 5x
defaults (reference: headers/qpsk_internal.h:32-35).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlecarrier_tpu.config import ModemConfig
from singlecarrier_tpu.modem import prod_rx_init, tx_stream
from singlecarrier_tpu.modem.rx_production import (prod_rx_batch,
                                                   prod_rx_stream)

_batch = jax.jit(prod_rx_batch, static_argnames=("cfg", "descramble"))

# 9.6 kHz / 2400 baud / 4x oversampling / 1500 Hz carrier
ALT = ModemConfig(fs=9600.0, rs=2400.0, center=1500.0)

# Tiny-payload numerology (D = 2 data symbols, n_sym = 130): the
# front-end's last symbol tile is mostly padding.
FALLBACK = ModemConfig(data_symbols=1, ns=2, hunt_dtype="int8")

# Mid-payload numerology (D = 72, n_sym = 200).
QRING_OFF = ModemConfig(data_symbols=9, ns=8, hunt_dtype="int8")


def _roundtrip_frames(cfg, n_pkts=3, seed=3):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_pkts, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True))
    n = -(-len(pcm) // cfg.frame_size) + 1
    buf = np.zeros(n * cfg.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    return bits, buf.reshape(n, cfg.frame_size)


@pytest.mark.parametrize("cfg", [FALLBACK, QRING_OFF],
                         ids=["chunk_fallback", "qring_off"])
def test_fused_fallback_chains_decode(cfg):
    """Short and mid-length payload numerologies (symbols per block not
    a multiple of the front-end tile) decode through the batch core
    with the scan oracle's decisions."""
    bits, frames = _roundtrip_frames(cfg)
    _, out = prod_rx_stream(cfg, prod_rx_init(cfg),
                            jnp.asarray(frames), descramble=False)
    v = np.asarray(out.valid)
    got = np.asarray(out.bits)[v]
    assert v.sum() == len(bits)
    assert np.array_equal(got, bits.reshape(-1, cfg.bits_per_frame))

    C = 2
    n = frames.shape[0]
    batch = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (n, C, cfg.frame_size)).copy())
    _, ob = _batch(cfg, prod_rx_init(cfg, (C,)), batch, descramble=False)
    for c in range(C):
        assert np.array_equal(np.asarray(ob.valid[:, c]), v)
        assert np.array_equal(np.asarray(ob.bits[:, c])[v], got)
        assert np.array_equal(np.asarray(ob.lag[:, c]),
                              np.asarray(out.lag))


def test_alt_numerology_roundtrip():
    assert ALT.cycles == 4
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, ALT.ns, ALT.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(ALT, jnp.asarray(bits), flush_gap=True))
    n = -(-len(pcm) // ALT.frame_size) + 1
    buf = np.zeros(n * ALT.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    frames = buf.reshape(n, ALT.frame_size)

    # XLA scan path
    _, out = prod_rx_stream(ALT, prod_rx_init(ALT), jnp.asarray(frames),
                            descramble=False)
    v = np.asarray(out.valid)
    got = np.asarray(out.bits)[v]
    assert np.array_equal(got, bits.reshape(-1, ALT.bits_per_frame))

    # batch core agrees exactly
    C = 2
    batch = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (n, C, ALT.frame_size)).copy())
    _, ob = _batch(ALT, prod_rx_init(ALT, (C,)), batch, descramble=False)
    for c in range(C):
        assert np.array_equal(np.asarray(ob.valid[:, c]), v)
        assert np.array_equal(np.asarray(ob.bits[:, c])[v], got)
        assert np.array_equal(np.asarray(ob.lag[:, c]),
                              np.asarray(out.lag))
