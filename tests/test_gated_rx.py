"""Detection-gated two-phase RX (modem/rx_gated.py).

The gated pipeline (the batch core cut after the gate -> shape-static
compaction -> the core over the compacted pairs) must reproduce the
full batch core's decisions, including for detections at block 0 of a
dispatch -- the cross-dispatch case the streaming state exists for
(the pair's prev block and its tail seed ride GatedRxState).
"""

import jax
import jax.numpy as jnp
import numpy as np

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import (prod_rx_batch_gated,
                                     prod_rx_gated_init, prod_rx_init,
                                     tx_stream)
from singlecarrier_tpu.modem.rx_production import prod_rx_batch


def _stream(n_packets=3, seed=71, C=4):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_packets, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n = -(-len(pcm) // CFG.frame_size) + 1
    buf = np.zeros(n * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    frames = buf.reshape(n, CFG.frame_size)
    batch = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (n, C, CFG.frame_size)).copy())
    return bits, batch


def _full_reference(batch, C):
    _, out = jax.jit(lambda s, p: prod_rx_batch(CFG, s, p,
                                                descramble=False))(
        prod_rx_init(CFG, (C,)), batch)
    return out


def _gated(st, batch, K):
    return jax.jit(lambda s, p: prod_rx_batch_gated(
        CFG, s, p, max_detections=K, descramble=False))(st, batch)


def _check_rows(out_g, full, C, b_off=0):
    """Every gated row maps to the identical full-path decision."""
    v = np.asarray(out_g["valid"])
    rows = 0
    for i in np.nonzero(v)[0]:
        b = int(out_g["block_idx"][i]) + b_off
        c = int(out_g["channel_idx"][i])
        assert np.asarray(full.valid)[b, c]
        assert np.array_equal(np.asarray(out_g["bits"][i]),
                              np.asarray(full.bits)[b, c])
        assert int(out_g["matches"][i]) == int(full.matches[b, c])
        assert int(out_g["lag"][i]) == int(full.lag[b, c])
        assert int(out_g["timing_phase"][i]) == int(
            full.timing_phase[b, c])
        rows += 1
    return rows


def test_gated_rx_matches_full_path_single_dispatch():
    C = 4
    bits, batch = _stream(C=C)
    full = _full_reference(batch, C)
    n_valid = int(np.asarray(full.valid).sum())

    st = prod_rx_gated_init(CFG, C)
    st, out_g = _gated(st, batch, 2 * n_valid)
    # the energy gate alone fires on MORE blocks than the final
    # criterion (partial-preamble neighbors pass the gate, phase 2's
    # match threshold rejects them) -- count reports gate hits
    assert int(out_g["count"]) >= n_valid
    assert int(out_g["count"]) <= 2 * n_valid
    assert int(np.asarray(out_g["valid"]).sum()) == n_valid
    assert _check_rows(out_g, full, C) == n_valid


def test_gated_rx_streaming_seam_block0_detection():
    """Split the stream so a detection lands on block 0 of the second
    dispatch: the carried pcm_prev / tail seeds must reproduce the
    one-dispatch decode bit-for-bit."""
    C = 4
    bits, batch = _stream(C=C)
    full = _full_reference(batch, C)
    vb = np.nonzero(np.asarray(full.valid)[:, 0])[0]
    # split exactly at a detection block -> it becomes block 0 of the
    # second dispatch (needs prev pcm from dispatch 1)
    split = int(vb[1])
    assert split >= 2
    n_valid = int(np.asarray(full.valid).sum())

    st = prod_rx_gated_init(CFG, C)
    st, out_a = _gated(st, batch[:split], 16)
    st, out_b = _gated(st, batch[split:], 16)

    got = (_check_rows(out_a, full, C)
           + _check_rows(out_b, full, C, b_off=split))
    assert got == n_valid
    # the seam case actually occurred: some dispatch-2 row at block 0
    vb2 = np.asarray(out_b["valid"]) & (
        np.asarray(out_b["block_idx"]) == 0)
    assert vb2.any()


def test_gated_rx_non_128_multiple_channels_trace(monkeypatch):
    """Any channel count and capacity traces: C=192 (not a power of
    two) and a K that divides nothing, through a small work budget
    that splits both phases into channel chunks.  eval_shape keeps
    this cheap."""
    from singlecarrier_tpu.modem import rx_production

    monkeypatch.setattr(rx_production, "WORK_BYTES", 1 << 26)
    C, B, K = 192, 2, 12
    st = prod_rx_gated_init(CFG, C)
    pcm = jnp.zeros((B, C, CFG.frame_size), jnp.int16)
    out_shape = jax.eval_shape(
        lambda s, p: prod_rx_batch_gated(
            CFG, s, p, max_detections=K),
        st, pcm)
    assert out_shape[1]["bits"].shape == (K, CFG.bits_per_frame)
    assert out_shape[0].planes[4].shape == (
        C, CFG.cycles, 2, CFG.symbols_per_block)


def test_gated_rx_capacity_truncation_reported():
    C = 4
    _, batch = _stream(C=C)
    st = prod_rx_gated_init(CFG, C)
    st, out_g = _gated(st, batch, 2)
    assert int(out_g["count"]) > 2          # truncation is visible
    assert int(np.asarray(out_g["valid"]).sum()) <= 2
