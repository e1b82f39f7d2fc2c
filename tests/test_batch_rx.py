"""Block-parallel batch RX (prod_rx_batch) vs the scan oracle.

prod_rx_batch removes the lax.scan by computing every carry in closed
form (mixer phase = phase0 * adv^b, FIR halo = downmixed tail of the
previous raw block, hunt window = neighbor batch element).  The float
path differs only by ulp-level reassociation from the scan path, so
decisions (valid/bits/lag) must be identical on a real stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import prod_rx_init, tx_stream
from singlecarrier_tpu.modem.rx_production import (
    _hunt,
    _hunt_planes,
    prod_rx_batch,
    prod_rx_stream,
)

# jit once per (cfg, descramble): eager dispatch of the batched decode
# is op-by-op and slow on the CPU backend
_batch = jax.jit(prod_rx_batch, static_argnames=("cfg", "descramble"))


def _batch_with_budget(monkeypatch, work_bytes, state, pcm):
    """The core traced under a ``WORK_BYTES`` of ``work_bytes`` (a fresh
    jit, so no trace made under another budget is reused)."""
    from singlecarrier_tpu.modem import rx_production

    monkeypatch.setattr(rx_production, "WORK_BYTES", work_bytes)
    return jax.jit(lambda s, p: prod_rx_batch(CFG, s, p,
                                              descramble=False))(state, pcm)


def _frames(n_packets=3, seed=41):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_packets, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n = -(-len(pcm) // CFG.frame_size) + 1
    buf = np.zeros(n * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    return bits, buf.reshape(n, CFG.frame_size)


def _broadcast(frames, C):
    return jnp.asarray(np.broadcast_to(
        frames[:, None, :], (len(frames), C, CFG.frame_size)).copy())


def _assert_same_decisions(a, b):
    """Decision-level equality of two ProdRxOut trees."""
    a = jax.tree.map(np.asarray, a)
    b = jax.tree.map(np.asarray, b)
    assert np.array_equal(a.valid, b.valid)
    assert np.array_equal(a.lag, b.lag)
    assert np.array_equal(a.timing_phase, b.timing_phase)
    v = a.valid
    assert np.array_equal(a.bits[v], b.bits[v])
    assert np.array_equal(a.matches[v], b.matches[v])


def test_batch_rx_matches_scan_xla():
    bits, frames = _frames()
    C = 4
    st, out_b = _batch(CFG, prod_rx_init(CFG, (C,)), _broadcast(frames, C),
                       descramble=False)
    _, out_x = prod_rx_stream(CFG, prod_rx_init(CFG),
                              jnp.asarray(frames), descramble=False)

    vx = np.asarray(out_x.valid)
    for c in range(C):
        assert np.array_equal(np.asarray(out_b.valid[:, c]), vx)
        assert np.array_equal(np.asarray(out_b.bits[:, c])[vx],
                              np.asarray(out_x.bits)[vx])
        assert np.array_equal(np.asarray(out_b.lag[:, c]),
                              np.asarray(out_x.lag))
        assert np.allclose(np.asarray(out_b.peak[:, c]),
                           np.asarray(out_x.peak), rtol=1e-4)
    got = np.asarray(out_b.bits[:, 0])[np.asarray(out_b.valid[:, 0])]
    assert np.array_equal(got, bits.reshape(-1, CFG.bits_per_frame))

    # final state sanity: unit phase, finite leaves
    assert np.allclose(np.abs(np.asarray(st.phase.real)**2
                              + np.asarray(st.phase.imag)**2), 1.0,
                       atol=1e-5)


def test_batch_rx_espan_hunt_norm_matches_xla_and_decodes():
    """cfg.hunt_norm="espan" (shared full-rate-span energy normalizer):
    the batch core's decisions equal the scan oracle's, for the bf16
    and int8 hunts, and the sent payload decodes."""
    bits, frames = _frames(seed=53)
    C = 4
    for cfg in (CFG.replace(hunt_norm="espan"),
                CFG.replace(hunt_norm="espan", hunt_dtype="int8")):
        _, out_b = _batch(cfg, prod_rx_init(cfg, (C,)),
                          _broadcast(frames, C), descramble=False)
        _, out_x = prod_rx_stream(cfg, prod_rx_init(cfg),
                                  jnp.asarray(frames), descramble=False)
        ref = jax.tree.map(
            lambda x: jnp.broadcast_to(x[:, None], (x.shape[0], C)
                                       + x.shape[1:]), out_x)
        _assert_same_decisions(out_b, ref)
        v = np.asarray(out_b.valid)
        got = np.asarray(out_b.bits)[:, 0][v[:, 0]]
        assert np.array_equal(got, bits.reshape(-1, CFG.bits_per_frame))


def test_batch_rx_refit_symbols_matches_xla_and_decodes():
    """cfg.ls_refit_symbols (refit-window knob): the batch core and the
    scan oracle fit the decision-directed refit on the first R data
    windows, so decisions stay identical between paths, and on a clean
    stream the truncated refit still decodes the payload bit-exact."""
    bits, frames = _frames(seed=59)
    C = 4
    cfg = CFG.replace(ls_refit_symbols=128)
    _, out_b = _batch(cfg, prod_rx_init(cfg, (C,)), _broadcast(frames, C),
                      descramble=False)
    _, out_x = prod_rx_stream(cfg, prod_rx_init(cfg), jnp.asarray(frames),
                              descramble=False)

    v = np.asarray(out_x.valid)
    for c in range(C):
        assert np.array_equal(np.asarray(out_b.valid[:, c]), v)
        assert np.array_equal(np.asarray(out_b.bits[:, c])[v],
                              np.asarray(out_x.bits)[v])
    got = np.asarray(out_b.bits)[:, 0][np.asarray(out_b.valid)[:, 0]]
    assert np.array_equal(got, bits.reshape(-1, CFG.bits_per_frame))


def test_superstep_stream_matches_batch():
    """prod_rx_stream_superstep (scan over K-block groups, batch path
    inside) reproduces one big batch call exactly -- the splice between
    groups is the same closed-form state carry."""
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import (
        prod_rx_stream_superstep)

    _, frames = _frames(n_packets=4, seed=71)
    n = len(frames) - (len(frames) % 2)
    C = 4
    batch = _broadcast(frames[:n], C)

    _, out_b = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                      descramble=False)
    _, out_s = jax.jit(lambda s, p: prod_rx_stream_superstep(
        CFG, s, p, superstep=2, descramble=False))(
            prod_rx_init_planes(CFG, C), batch)
    _assert_same_decisions(out_s, out_b)


def test_batch_rx_int8_hunt_matches_xla_and_decodes():
    """cfg.hunt_dtype="int8": the quantized-correlation hunt (int32
    accumulation is exact) gives the oracle's decisions running the
    SAME quantized math, keeps the bf16 hunt's detections on a clean
    stream, and decodes the payload -- the ~-40 dBc quantization floor
    is far below the detection statistic's noise."""
    cfg = CFG.replace(hunt_dtype="int8")
    bits, frames = _frames(seed=53)
    C = 4
    batch = _broadcast(frames, C)

    _, out_f = _batch(cfg, prod_rx_init(cfg, (C,)), batch,
                      descramble=False)
    _, out_x = prod_rx_stream(cfg, prod_rx_init(cfg), jnp.asarray(frames),
                              descramble=False)
    v = np.asarray(out_x.valid)
    assert np.array_equal(np.asarray(out_f.valid[:, 0]), v)
    assert np.array_equal(np.asarray(out_f.lag[:, 0]),
                          np.asarray(out_x.lag))
    assert np.array_equal(np.asarray(out_f.bits[:, 0])[v],
                          np.asarray(out_x.bits)[v])

    # int8 quantization must not change the bf16 hunt's DECISIONS on a
    # clean stream (peak/lag selection is noise-margined)
    _, out_ref = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                        descramble=False)
    vf = np.asarray(out_f.valid)
    assert np.array_equal(vf, np.asarray(out_ref.valid))
    # lag compared on DETECTED blocks only: on the no-signal tail
    # blocks the espan-normalized statistic is a ~0/~0 knife-edge
    assert np.array_equal(np.asarray(out_f.lag)[vf],
                          np.asarray(out_ref.lag)[vf])
    # peak statistic back in matched-filter units (1/s^2 rescale); the
    # round() bias is coherent across the chips of a clean preamble,
    # a deterministic few-% offset -- irrelevant to a gated statistic
    assert np.allclose(np.asarray(out_f.peak)[vf],
                       np.asarray(out_ref.peak)[vf], rtol=0.15)
    got = np.asarray(out_f.bits[:, 0])[vf[:, 0]]
    assert np.array_equal(got, bits.reshape(-1, CFG.bits_per_frame))


def test_batch_rx_on_shipped_golden_vector(golden_raw):
    """The batch core decodes the reference's shipped 10-packet vector
    (preamble_qpsk_8k.raw) with the same decisions as the scan oracle
    (10/10 detects; the reference itself detects 3 --
    modem/rx_production.py docstring)."""
    n = -(-len(golden_raw) // CFG.frame_size) + 1
    buf = np.zeros(n * CFG.frame_size, np.int16)
    buf[:len(golden_raw)] = golden_raw
    frames = buf.reshape(n, CFG.frame_size)
    C = 2
    _, ob = _batch(CFG, prod_rx_init(CFG, (C,)), _broadcast(frames, C),
                   descramble=True)
    _, ox = prod_rx_stream(CFG, prod_rx_init(CFG), jnp.asarray(frames),
                           descramble=True)

    vx = np.asarray(ox.valid)
    assert vx.sum() == 10
    for c in range(C):
        assert np.array_equal(np.asarray(ob.valid[:, c]), vx)
        assert np.array_equal(np.asarray(ob.bits[:, c])[vx],
                              np.asarray(ox.bits)[vx])


def test_batch_rx_int8_hunt_detection_low_snr():
    """int8 hunt quantization must not cost detections at low SNR:
    at 3 dB passband SNR + 20 Hz CFO the int8 hunt detects the same
    packets as the f32 hunt (its ~-40 dBc quantization floor sits far
    below the channel noise in the non-coherent statistic)."""
    from singlecarrier_tpu.channel import channel

    C, n_pkts = 4, 3
    rng = np.random.default_rng(67)
    bits = rng.integers(0, 2, (C, n_pkts, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, jnp.asarray(bits), flush_gap=True)     # [C, S]
    n = -(-pcm.shape[-1] // CFG.frame_size) + 1
    pad = n * CFG.frame_size - pcm.shape[-1]
    x = jnp.pad(pcm.astype(jnp.float32), ((0, 0), (0, pad)))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    x = jax.vmap(lambda k, s: channel(k, s, snr_db=3.0, freq_hz=20.0,
                                      fs=CFG.fs))(keys, x)
    frames = jnp.swapaxes(
        x.astype(jnp.int16).reshape(C, n, CFG.frame_size), 0, 1)

    det = {}
    for hd in ("f32", "int8"):
        cfg = CFG.replace(hunt_dtype=hd)
        _, o = _batch(cfg, prod_rx_init(cfg, (C,)), frames,
                      descramble=False)
        det[hd] = np.asarray(o.valid)
    assert det["f32"].sum() == C * n_pkts            # all found at f32
    assert np.array_equal(det["int8"], det["f32"])   # int8 loses none


def test_batch_rx_plane_state_matches_complex():
    """The plane-typed state (prod_rx_init_planes; carried in the
    core's channel-major [C, cyc, 2, n_sym] layout) decodes identically
    to the complex ProdRxState, including across a split-stream carry,
    and converts back to the complex carry."""
    from singlecarrier_tpu.modem import (planes_to_state,
                                     prod_rx_init_planes)

    _, frames = _frames(seed=59)
    n = len(frames)
    C = 2
    batch = _broadcast(frames, C)

    st_c, out_c = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                         descramble=False)
    st_p, out_p = _batch(CFG, prod_rx_init_planes(CFG, C), batch,
                         descramble=False)
    _assert_same_decisions(out_p, out_c)
    assert isinstance(st_p, tuple) and len(st_p) == 5

    # split-stream carry in plane form == one call
    cut = n // 2
    st1, out_a = _batch(CFG, prod_rx_init_planes(CFG, C), batch[:cut],
                        descramble=False)
    _, out_b2 = _batch(CFG, st1, batch[cut:], descramble=False)
    joined = jax.tree.map(
        lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]),
        out_a, out_b2)
    _assert_same_decisions(joined, out_c)

    st_rt = planes_to_state(st_p)
    assert np.allclose(np.asarray(st_rt.phase.real),
                       np.asarray(st_c.phase.real), atol=1e-6)
    assert np.allclose(np.asarray(st_rt.decim_prev),
                       np.asarray(st_c.decim_prev), atol=1e-6)


def test_batch_rx_state_carry_across_calls():
    """Splitting the stream into two prod_rx_batch calls (state carried
    between them) decodes identically to one call -- the closed-form
    carries splice exactly."""
    _, frames = _frames(seed=43)
    n = len(frames)
    C = 2
    batch = _broadcast(frames, C)

    _, out_full = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                         descramble=False)
    cut = n // 2
    st, out_a = _batch(CFG, prod_rx_init(CFG, (C,)), batch[:cut],
                       descramble=False)
    _, out_c = _batch(CFG, st, batch[cut:], descramble=False)
    joined = jax.tree.map(
        lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]),
        out_a, out_c)
    _assert_same_decisions(joined, out_full)


def _distinct_channels(frames, C):
    """[B, C, n]: channel c carries the stream delayed by 137*c
    samples, so a channel landing in the wrong slot changes lag."""
    flat = frames.reshape(-1)
    rows = [np.roll(flat, 137 * c).reshape(frames.shape)
            for c in range(C)]
    return jnp.asarray(np.stack(rows, 1))


@pytest.mark.parametrize("C", [3, 15])
def test_batch_rx_channel_counts_without_power_of_two_factor(C,
                                                             monkeypatch):
    """Channel counts with no power-of-two factor run, and a small work
    budget (several channel chunks, the last one clamped to overlap its
    neighbor) gives the decisions of one whole dispatch, channel by
    channel."""
    from singlecarrier_tpu.modem.rx_production import _pair_bytes

    _, frames = _frames(seed=83)
    batch = _distinct_channels(frames, C)
    B = batch.shape[0]
    st1, one = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                      descramble=False)
    small = 2 * B * _pair_bytes(CFG)           # two channels per chunk
    st2, chunked = _batch_with_budget(monkeypatch, small,
                                      prod_rx_init(CFG, (C,)), batch)
    _assert_same_decisions(chunked, one)
    assert np.asarray(one.valid).sum() >= 2 * C
    assert np.allclose(np.asarray(st1.decim_prev),
                       np.asarray(st2.decim_prev), atol=1e-6)


def test_batch_rx_chunked_hunt_equals_unchunked(monkeypatch):
    """One channel per chunk (the smallest work budget) equals one
    dispatch: decisions exactly, float statistics to rounding."""
    _, frames = _frames(seed=89)
    C = 4
    batch = _distinct_channels(frames, C)
    _, one = _batch(CFG, prod_rx_init(CFG, (C,)), batch,
                    descramble=False)
    _, chunked = _batch_with_budget(monkeypatch, 1,
                                    prod_rx_init(CFG, (C,)), batch)
    _assert_same_decisions(chunked, one)
    for name in ("peak", "energy", "eq_error"):
        assert np.allclose(np.asarray(getattr(chunked, name)),
                           np.asarray(getattr(one, name)),
                           rtol=1e-4, atol=1e-6), name


@pytest.mark.parametrize("hunt_norm", ["espan", "none"])
@pytest.mark.parametrize("hunt_dtype", ["f32", "bf16", "int8"])
def test_hunt_planes_matches_complex_hunt(hunt_dtype, hunt_norm):
    """The batch core's plane-typed hunt equals the oracle's complex
    hunt on real hunt windows (same lag, phase and peak), and locates
    every packet of the stream."""
    from singlecarrier_tpu.dsp.frontend import frontend_reference

    cfg = CFG.replace(hunt_dtype=hunt_dtype, hunt_norm=hunt_norm)
    bits, frames = _frames(seed=97)
    st = prod_rx_init(cfg)
    filt = []
    for f in frames:
        y, tail, phase = frontend_reference(cfg, jnp.asarray(f),
                                            st.phase, st.fir_tail)
        st = st._replace(phase=phase, fir_tail=tail)
        filt.append(np.asarray(y).reshape(cfg.symbols_per_block,
                                          cfg.cycles).T)
    decim = np.stack(filt)                              # [B, cyc, n_sym]
    prev = np.concatenate([np.zeros_like(decim[:1]), decim[:-1]])
    windows = np.concatenate([prev, decim], -1)         # [B, cyc, 2n]
    planes = np.stack([windows.real, windows.imag], 2).astype(np.float32)

    lag_c, ph_c, pk_c, _ = jax.jit(lambda w: _hunt(cfg, w))(
        jnp.asarray(windows.astype(np.complex64)))
    lag_p, ph_p, pk_p = jax.jit(lambda w: _hunt_planes(cfg, w))(
        jnp.asarray(planes))
    assert np.array_equal(np.asarray(lag_p), np.asarray(lag_c))
    assert np.array_equal(np.asarray(ph_p), np.asarray(ph_c))
    assert np.allclose(np.asarray(pk_p), np.asarray(pk_c), rtol=1e-5)

    # every packet start (sample p*packet_size of the stream, plus the
    # TX+RX matched-filter delay of ntaps-1 samples) is found
    pos = ((np.arange(len(frames)) - 1) * cfg.frame_size
           + np.asarray(lag_p) * cfg.cycles + np.asarray(ph_p))
    for p in range(len(bits)):
        err = pos - p * cfg.packet_size - (cfg.ntaps - 1)
        assert np.min(np.abs(err)) <= 1, p
