"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Seam correctness is the hard part (SURVEY.md hard-part #5): the same
stream demodulated on 1 device and on N devices must produce identical
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import (
    make_prod_rx_fn,
    prod_rx_init,
    tx_stream,
)
from singlecarrier_tpu.modem.rx_production import (
    prod_rx_batch,
    prod_rx_init_planes,
)
from singlecarrier_tpu.parallel import (
    make_channel_sharded_rx,
    make_mesh,
    make_sharded_batch_rx,
    make_time_sharded_rx,
    shard_channel_state,
    shard_plane_state,
)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (10, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    # pad to a multiple of 8 frames (14.8 -> 16)
    n = 16
    buf = np.zeros(n * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    return bits, buf.reshape(n, CFG.frame_size)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_channel_sharded_rx_matches_single(stream):
    bits, frames = stream
    mesh = make_mesh(ch=8, time=1)
    n_ch = 16

    batch = jnp.asarray(np.broadcast_to(
        frames, (n_ch, *frames.shape)).copy())
    fn = make_channel_sharded_rx(CFG, mesh, descramble=False)
    state = shard_channel_state(prod_rx_init(CFG, (n_ch,)), mesh)
    _, out = fn(state, batch)

    ref_fn = make_prod_rx_fn(CFG, descramble=False)
    _, ref = ref_fn(prod_rx_init(CFG), jnp.asarray(frames))

    for c in range(n_ch):
        assert np.array_equal(np.asarray(out.valid[c]),
                              np.asarray(ref.valid))
        assert np.array_equal(np.asarray(out.bits[c]),
                              np.asarray(ref.bits))


def test_sharded_metrics_reduction(stream):
    """metrics_summary reduces across the sharded channel axis (the
    all-reduce XLA lowers to psum over the mesh): jitted-on-mesh values
    must equal the host-side computation on gathered arrays."""
    from singlecarrier_tpu.parallel import metrics_summary

    bits, frames = stream
    mesh = make_mesh(ch=8, time=1)
    n_ch = 16
    batch = jnp.asarray(np.broadcast_to(
        frames, (n_ch, *frames.shape)).copy())
    fn = make_channel_sharded_rx(CFG, mesh, descramble=False)
    state = shard_channel_state(prod_rx_init(CFG, (n_ch,)), mesh)
    _, out = fn(state, batch)

    m = jax.jit(metrics_summary)(out)   # reduction over sharded leaves
    valid = np.asarray(out.valid)
    cfo = np.asarray(out.cfo_hz)
    eqe = np.asarray(out.eq_error)
    assert int(m["packets_detected"]) == int(valid.sum()) == 10 * n_ch
    assert np.isclose(float(m["mean_cfo_hz"]),
                      cfo[valid].mean(), atol=1e-5)
    assert np.isclose(float(m["mean_eq_error"]),
                      eqe[valid].mean(), rtol=1e-5)


@pytest.mark.parametrize("work_bytes", [None, 1],
                         ids=["one_chunk", "chunked"])
def test_fused_sharded_rx_matches_single_device(stream, work_bytes,
                                                monkeypatch):
    """The batch core under a channel-axis shard_map: each of the 8
    virtual devices runs the core over its channel shard (whole, or in
    one-channel chunks); the result must equal the single-device core
    -- outputs AND carried plane state -- and decode the real packet
    stream."""
    from singlecarrier_tpu.modem import rx_production

    bits, frames = stream
    mesh = make_mesh(ch=8, time=1)
    n_ch = 16
    B = frames.shape[0]

    pcm = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (B, n_ch, CFG.frame_size)).copy())

    # jit the reference too: the comparison isolates SHARDING effects,
    # not eager-vs-compiled reassociation.  It runs the whole dispatch
    # as one chunk.
    st_1, out_1 = jax.jit(
        lambda st, p: prod_rx_batch(CFG, st, p, descramble=False)
    )(prod_rx_init_planes(CFG, n_ch), pcm)

    if work_bytes is not None:
        monkeypatch.setattr(rx_production, "WORK_BYTES", work_bytes)
    fn = make_sharded_batch_rx(CFG, mesh, descramble=False)
    st_sh, out_sh = fn(shard_plane_state(prod_rx_init_planes(CFG, n_ch),
                                         mesh), pcm)

    out_sh = jax.tree.map(np.asarray, out_sh)
    out_1 = jax.tree.map(np.asarray, out_1)
    for name, a, b in zip(out_1._fields, out_sh, out_1):
        if a.dtype.kind == "f":
            # XLA's fusion context differs under shard_map and with the
            # per-device batch size -> last-ulp deltas on the float
            # stats (at most 6.2e-8 relative, on eq_error, when
            # chunked).  Decisions stay exact.
            assert np.allclose(a, b, rtol=2e-6, atol=1e-6), (
                f"sharded != single on {name}")
        else:
            assert np.array_equal(a, b), f"sharded != single on {name}"
    for i, (a, b) in enumerate(zip(st_sh, st_1)):
        assert np.allclose(np.asarray(a), np.asarray(b),
                           rtol=2e-6, atol=1e-6), (
            f"state plane {i} differs across the shard seam")

    # the real packet stream decodes through the sharded program
    v = out_sh.valid
    assert v.sum() == 10 * n_ch
    for c in range(n_ch):
        got = out_sh.bits[:, c][v[:, c]]
        assert np.array_equal(got,
                              bits.reshape(10, CFG.bits_per_frame))


def test_fused_sharded_rx_state_carry_across_calls(stream):
    """Splicing the batch core across shards AND across dispatches:
    two consecutive sharded calls (8-device mesh) must equal one
    single-device call over the concatenated stream."""
    bits, frames = stream
    mesh = make_mesh(ch=8, time=1)
    n_ch = 8
    B = frames.shape[0]
    assert B % 2 == 0
    pcm = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (B, n_ch, CFG.frame_size)).copy())

    fn = make_sharded_batch_rx(CFG, mesh, descramble=False)
    st = shard_plane_state(prod_rx_init_planes(CFG, n_ch), mesh)
    st, out_a = fn(st, pcm[:B // 2])
    st, out_b = fn(st, pcm[B // 2:])
    out_sp = jax.tree.map(
        lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)], 0),
        out_a, out_b)

    _, out_1 = jax.jit(
        lambda st, p: prod_rx_batch(CFG, st, p, descramble=False)
    )(prod_rx_init_planes(CFG, n_ch), pcm)
    out_1 = jax.tree.map(np.asarray, out_1)
    # decision-level equality (the carried phase is renormalized at the
    # call boundary, so float stats may differ in ulps -- same contract
    # as test_batch_rx_state_carry_across_calls)
    assert np.array_equal(out_sp.valid, out_1.valid)
    assert np.array_equal(out_sp.bits[out_1.valid],
                          out_1.bits[out_1.valid])
    assert np.array_equal(out_sp.lag, out_1.lag)
    assert np.array_equal(out_sp.timing_phase, out_1.timing_phase)


def test_time_sharded_seam_exactness(stream):
    """Overlap-save halo exchange: identical decisions across shard
    seams vs the single-device scan."""
    bits, frames = stream
    mesh = make_mesh(ch=1, time=8)

    fn = make_time_sharded_rx(CFG, mesh, descramble=False)
    out = fn(jnp.asarray(frames))

    ref_fn = make_prod_rx_fn(CFG, descramble=False)
    _, ref = ref_fn(prod_rx_init(CFG), jnp.asarray(frames))

    out = jax.tree.map(np.asarray, out)
    ref = jax.tree.map(np.asarray, ref)

    assert np.array_equal(out.valid, ref.valid), (
        f"valid mismatch: sharded {np.where(out.valid)[0]} "
        f"vs single {np.where(ref.valid)[0]}")
    assert np.array_equal(out.bits[out.valid], ref.bits[ref.valid])
    # all 10 packets survive the seams
    assert out.valid.sum() == 10
    got = out.bits[out.valid]
    assert np.array_equal(got, bits.reshape(10, CFG.bits_per_frame))


def test_time_sharded_two_devices(stream):
    bits, frames = stream
    mesh = make_mesh(ch=1, time=2, devices=jax.devices()[:2])
    fn = make_time_sharded_rx(CFG, mesh, descramble=False)
    out = jax.tree.map(np.asarray, fn(jnp.asarray(frames)))
    assert out.valid.sum() == 10
    assert np.array_equal(out.bits[out.valid],
                          bits.reshape(10, CFG.bits_per_frame))


def test_2d_mesh_channels_and_time(stream):
    """Channels on 'ch' x time on 'time' simultaneously: vmap the
    time-sharded path over a sharded channel axis."""
    bits, frames = stream
    mesh = make_mesh(ch=4, time=2)
    from singlecarrier_tpu.parallel.timeshard import time_sharded_rx

    n_ch = 4
    batch = jnp.asarray(np.broadcast_to(
        frames, (n_ch, *frames.shape)).copy())

    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map
    from singlecarrier_tpu.modem.rx_production import prod_rx_stream

    def per_channel(frames_local):
        return time_sharded_rx(CFG, frames_local, mesh,
                               descramble=False)

    fn = jax.jit(jax.vmap(lambda f: per_channel(f)))
    out = jax.tree.map(np.asarray, fn(batch))
    for c in range(n_ch):
        assert out.valid[c].sum() == 10
        assert np.array_equal(out.bits[c][out.valid[c]],
                              bits.reshape(10, CFG.bits_per_frame))


def test_fused_grid_sharded_rx_2d_seams(stream):
    """The batch core under a 2D [ch x time] shard_map: each time shard
    prepends one ppermuted halo block with closed-form carry seeds
    (overlap-save at block granularity).  Decisions must match the
    single-device core across BOTH seam types, and the real packet
    stream must decode."""
    from singlecarrier_tpu.parallel import make_grid_batch_rx

    bits, frames = stream
    mesh = make_mesh(ch=4, time=2)
    n_ch = 8
    B = frames.shape[0]
    pcm = jnp.asarray(np.broadcast_to(
        frames[:, None, :], (B, n_ch, CFG.frame_size)).copy())

    out = jax.tree.map(np.asarray,
                       make_grid_batch_rx(CFG, mesh, descramble=False)(pcm))
    _, ref = jax.jit(
        lambda st, p: prod_rx_batch(CFG, st, p, descramble=False)
    )(prod_rx_init_planes(CFG, n_ch), pcm)
    ref = jax.tree.map(np.asarray, ref)

    assert np.array_equal(out.valid, ref.valid)
    assert np.array_equal(out.bits[ref.valid], ref.bits[ref.valid])
    assert np.array_equal(out.lag, ref.lag)
    assert np.array_equal(out.timing_phase, ref.timing_phase)
    # every packet decodes through the 2D-sharded program
    for c in range(n_ch):
        v = out.valid[:, c]
        assert v.sum() == 10
        assert np.array_equal(out.bits[:, c][v],
                              bits.reshape(10, CFG.bits_per_frame))
