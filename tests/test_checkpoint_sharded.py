"""Sharded checkpoint/restore tests on the 8-device mesh.

The scalable checkpoint path (runtime/checkpoint.py save_sharded):
per-shard files, restored shard by shard onto the mesh -- no
gather-to-host -- and restore-and-replay is bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import prod_rx_init, tx_stream
from singlecarrier_tpu.modem.rx_production import prod_rx_stream
from singlecarrier_tpu.parallel.sharded_rx import (make_channel_sharded_rx,
                                                   shard_channel_state)
from singlecarrier_tpu.runtime import restore_sharded, save_sharded


N_CH = 8


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(jax.devices()[:8]), ("ch",))


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(33)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(CFG, jnp.asarray(bits), flush_gap=True))
    n_blocks = -(-len(pcm) // CFG.frame_size)
    buf = np.zeros(n_blocks * CFG.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    blocks = buf.reshape(n_blocks, CFG.frame_size)
    # [channels, frames, frame_size]
    return np.broadcast_to(blocks[None], (N_CH, n_blocks,
                                          CFG.frame_size)).copy()


def test_sharded_save_restore_roundtrip(mesh, tmp_path):
    state = shard_channel_state(prod_rx_init(CFG, (N_CH,)), mesh)
    # make it non-trivial
    state = state._replace(
        decim_prev=state.decim_prev + (1.0 + 2.0j))
    save_sharded(str(tmp_path / "ckpt"), state, step=7)
    restored, step = restore_sharded(str(tmp_path / "ckpt"), like=state)
    assert step == 7
    for got, want in zip(jax.tree.leaves(restored),
                         jax.tree.leaves(state)):
        # restored shards land on the same mesh/sharding
        assert got.sharding == want.sharding, (got.sharding, want.sharding)
        np.testing.assert_array_equal(
            np.asarray(got.real), np.asarray(want.real))
        if jnp.iscomplexobj(want):
            np.testing.assert_array_equal(
                np.asarray(got.imag), np.asarray(want.imag))


def test_sharded_restore_and_replay_bit_identical(mesh, stream, tmp_path):
    """Demodulate half the stream, checkpoint the SHARDED state,
    restore onto the mesh, replay the rest: identical bits to the
    uninterrupted sharded run."""
    fn = make_channel_sharded_rx(CFG, mesh, descramble=False)
    state0 = shard_channel_state(prod_rx_init(CFG, (N_CH,)), mesh)
    pcm = jnp.asarray(stream)

    _, full_out = fn(state0, pcm)

    cut = stream.shape[1] // 2
    st_half, _ = fn(state0, pcm[:, :cut])
    save_sharded(str(tmp_path / "mid"), st_half, step=cut)

    restored, step = restore_sharded(str(tmp_path / "mid"), like=state0)
    assert step == cut
    _, rest_out = fn(restored, pcm[:, cut:])

    np.testing.assert_array_equal(np.asarray(rest_out.valid),
                                  np.asarray(full_out.valid)[:, cut:])
    np.testing.assert_array_equal(np.asarray(rest_out.bits),
                                  np.asarray(full_out.bits)[:, cut:])


def test_plane_state_checkpoint_resume_headline_path(mesh, tmp_path):
    """Checkpoint/resume of the PLANE-TYPED state on the sharded mesh
    -- the state layout the batch core deploys with
    (prod_rx_init_planes + make_sharded_batch_rx).  Save mid-stream,
    restore onto the mesh, continue: decisions must match the
    uninterrupted run."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.modem import tx_stream
    from singlecarrier_tpu.modem.rx_production import (
        prod_rx_batch, prod_rx_init_planes)
    from singlecarrier_tpu.parallel import (make_sharded_batch_rx,
                                        shard_plane_state)
    from singlecarrier_tpu.runtime.checkpoint import (restore_sharded,
                                                      save_sharded)

    cfg = CFG
    C = 8
    rng = np.random.default_rng(31)
    bits = rng.integers(0, 2, (6, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True))
    B = 10
    buf = np.zeros(B * cfg.frame_size, np.int16)
    buf[:min(len(pcm), len(buf))] = pcm[:len(buf)]
    frames = jnp.asarray(np.broadcast_to(
        buf.reshape(B, 1, cfg.frame_size),
        (B, C, cfg.frame_size)).copy())

    fn = make_sharded_batch_rx(cfg, mesh, descramble=False)
    st = shard_plane_state(prod_rx_init_planes(cfg, C), mesh)
    st, out_a = fn(st, frames[:B // 2])

    # checkpoint the sharded plane tuple, restore onto the mesh
    # (the `like` tree carries the shardings: shards load straight
    # onto the devices that own them)
    save_sharded(str(tmp_path / "planes"), st)
    st_r, step = restore_sharded(str(tmp_path / "planes"), st)
    st_r = tuple(st_r)
    st_r, out_b = fn(st_r, frames[B // 2:])

    # uninterrupted reference
    _, ref = jax.jit(lambda s, p: prod_rx_batch(
        cfg, s, p, descramble=False))(prod_rx_init_planes(cfg, C), frames)
    ref = jax.tree.map(np.asarray, ref)
    got_v = np.concatenate([np.asarray(out_a.valid),
                            np.asarray(out_b.valid)], 0)
    got_b = np.concatenate([np.asarray(out_a.bits),
                            np.asarray(out_b.bits)], 0)
    assert np.array_equal(got_v, ref.valid)
    assert np.array_equal(got_b[ref.valid], ref.bits[ref.valid])


def test_sharded_restore_onto_other_layout(mesh, tmp_path):
    """Shards saved from an 8-way channel sharding restore onto a
    4-way mesh and onto an unsharded target: each target shard is
    assembled from the saved pieces that overlap it."""
    from singlecarrier_tpu.modem.rx_production import prod_rx_init_planes
    from singlecarrier_tpu.parallel import shard_plane_state

    rng = np.random.default_rng(5)
    planes = tuple(jnp.asarray(rng.normal(size=x.shape).astype(x.dtype))
                   for x in prod_rx_init_planes(CFG, N_CH))
    save_sharded(str(tmp_path / "p"), shard_plane_state(planes, mesh),
                 step=3)

    mesh4 = Mesh(np.array(jax.devices()[:4]), ("ch",))
    like = shard_plane_state(prod_rx_init_planes(CFG, N_CH), mesh4)
    got, step = restore_sharded(str(tmp_path / "p"), like)
    assert step == 3
    for g, w, l in zip(got, planes, like):
        assert g.sharding == l.sharding
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    flat = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        planes)
    got, _ = restore_sharded(str(tmp_path / "p"), flat)
    for g, w in zip(got, planes):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
