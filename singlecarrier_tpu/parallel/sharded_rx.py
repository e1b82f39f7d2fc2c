"""Channel-sharded demodulation (the DP scaling axis).

Channels are fully independent (the reference's per-channel state is a
few KB of statics -- SURVEY.md section 2 DP row), so scaling is pure
data parallelism: ``vmap`` the per-channel RX over a channel axis and
shard that axis over the mesh with ``NamedSharding``.  XLA partitions
everything automatically; there are no cross-channel collectives in the
demod path, only optional ``psum``-style metric reductions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModemConfig
from ..dsp.mixer import downmix_tail
from ..modem.rx_production import (ProdRxState, _advances, _rx_core,
                                   prod_rx_batch, prod_rx_stream)


def shard_channel_state(state: ProdRxState, mesh: Mesh) -> ProdRxState:
    """Place a batched state pytree with the leading axis on 'ch'."""
    def put(x):
        spec = P("ch", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, state)


def make_channel_sharded_rx(cfg: ModemConfig, mesh: Mesh, *,
                            descramble: bool = True):
    """jit-compiled [channels, frames, frame_size] -> ProdRxOut, with
    the channel axis sharded over the mesh's 'ch' axis.

    Returns ``fn(state, pcm) -> (state, out)``; build the initial state
    with ``prod_rx_init(cfg, (n_channels,))`` +
    ``shard_channel_state``.
    """
    vfn = jax.vmap(
        lambda st, pcm: prod_rx_stream(cfg, st, pcm,
                                       descramble=descramble))

    ch = NamedSharding(mesh, P("ch"))
    # Leading (channel) axis sharded on 'ch' for every input/output leaf;
    # XLA propagates the sharding through the whole pipeline with zero
    # cross-channel collectives.
    return jax.jit(vfn, in_shardings=ch, out_shardings=ch)


def _plane_specs(axis: str):
    """Plane-tuple sharding specs (prod_rx_init_planes layout): every
    leaf is channel-leading."""
    return (P(axis),) * 5


def shard_plane_state(planes, mesh: Mesh, *, axis: str = "ch"):
    """Place a plane-tuple state (prod_rx_init_planes) on the mesh with
    the channel axis sharded."""
    return tuple(
        jax.device_put(x, NamedSharding(mesh, spec))
        for x, spec in zip(planes, _plane_specs(axis)))


def make_sharded_batch_rx(cfg: ModemConfig, mesh: Mesh, *,
                          descramble: bool = True, axis: str = "ch"):
    """The block-parallel batch core under a channel-axis shard_map.

    Each device runs ``prod_rx_batch`` over its channel shard -- the
    deployable multi-card program for the 1M-channel target.  Channels
    are fully independent (the per-channel statics the axis shards:
    reference src/qpsk.c:34-53), so the sharded program contains ZERO
    collectives and outputs stay channel-sharded for the caller's
    metric reductions.

    Returns ``jit(fn)(planes, pcm) -> (planes, ProdRxOut)`` where
    ``planes`` is the plane-tuple state (``prod_rx_init_planes``,
    channel axis sharded -- use ``shard_plane_state``) and ``pcm`` is
    [n_blocks, C, frame_size] int16 with C divisible by the mesh's
    ``axis`` size.  The state is donated.
    """
    n_dev = mesh.shape[axis]

    def shard_fn(planes, pcm):
        return prod_rx_batch(cfg, planes, pcm, descramble=descramble)

    specs = _plane_specs(axis)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(specs, P(None, axis)),
        out_specs=(specs, P(None, axis)),
        check_vma=False,
    )

    def wrapped(planes, pcm):
        if pcm.shape[1] % n_dev:
            raise ValueError(
                f"channels ({pcm.shape[1]}) not divisible by mesh "
                f"'{axis}' size ({n_dev})")
        return fn(planes, pcm)

    return jax.jit(wrapped, donate_argnums=(0,))


def make_grid_batch_rx(cfg: ModemConfig, mesh: Mesh, *,
                       descramble: bool = True):
    """The batch core under a 2D [ch x time] shard_map (one-shot).

    Channels shard as pure DP; the TIME axis shards one stream's
    blocks with a ONE-BLOCK overlap-save halo: each shard ppermutes
    its last raw PCM block (plus the ntaps-1 samples before it) to its
    right neighbor and PREPENDS it to its local blocks as a halo block,
    seeded with closed-form carries --

      * mixer phase entering the halo slot = adv^(g-1) from the GLOBAL
        block index (no communication; for shard 0 that is adv^-1, so
        the first real block lands on adv^0 = the fresh-stream phase);
      * FIR tail entering the halo slot = the downmixed last ntaps-1
        samples of global block g-1 (part of the ppermuted halo).

    The halo block's decimated planes are the first real block's
    previous-block planes, exactly as in the unsharded core; the halo
    block itself gets no output row.  One redundant block of front-end
    per shard buys seam-free results ([n_blocks, C, ...] leaves, both
    axes sharded).  Decisions equal the single-device core
    (tests/test_sharding.py).

    ``pcm``: [n_blocks, n_channels, frame_size] int16, n_blocks
    divisible by mesh['time'] (and >= 2 per shard), n_channels by
    mesh['ch'].
    """
    n_t = mesh.shape["time"]
    n_c = mesh.shape["ch"]
    n = cfg.frame_size
    halo = cfg.ntaps - 1

    def shard_fn(pcm_local):
        # pcm_local: [B_loc, C_loc, n]
        B_loc, C_loc = pcm_local.shape[0], pcm_local.shape[1]
        t_idx = jax.lax.axis_index("time")
        is_first = t_idx == 0

        # halo to the right neighbor: my last block + the ntaps-1 raw
        # samples preceding it (from my second-to-last block)
        perm = [(i, i + 1) for i in range(n_t - 1)]
        in_blk = jax.lax.ppermute(pcm_local[-1], "time", perm)
        in_pre = jax.lax.ppermute(pcm_local[-2, :, n - halo:], "time",
                                  perm)
        in_blk = jnp.where(is_first, jnp.zeros_like(in_blk), in_blk)
        in_pre = jnp.where(is_first, jnp.zeros_like(in_pre), in_pre)

        # Closed-form carries at the halo slot g = t_idx*B_loc - 1,
        # from a host float64 table indexed by the shard (an f32
        # angle*g product would drift from the core's float64
        # tabulation with stream length).
        g = np.arange(n_t) * B_loc - 1.0
        ph1 = _advances(cfg, g)
        ph2 = _advances(cfg, g - 1.0)
        ones = jnp.ones((C_loc,), jnp.float32)
        p_r = jnp.asarray(ph1.real)[t_idx] * ones
        p_i = jnp.asarray(ph1.imag)[t_idx] * ones
        # FIR tail entering g = downmixed tail of block g-1 at
        # phase(g-1); zero for shard 0 (fresh) -- in_pre is zeroed
        x_t = in_pre.astype(jnp.float32) / cfg.tx_amplitude
        tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                                  jnp.asarray(ph2.real)[t_idx],
                                  jnp.asarray(ph2.imag)[t_idx])
        pcm_ext = jnp.concatenate([in_blk[None], pcm_local], axis=0)
        out, _ = _rx_core(cfg, pcm_ext, (p_r, p_i, tl_r, tl_i, None),
                          descramble=descramble)
        return out

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("time", "ch"),),
        out_specs=P("time", "ch"),
        check_vma=False,
    )

    def wrapped(pcm):
        B, C = pcm.shape[0], pcm.shape[1]
        if B % n_t or B // n_t < 2:
            raise ValueError(
                f"n_blocks ({B}) must be a multiple of mesh['time'] "
                f"({n_t}) with >= 2 blocks per shard")
        if C % n_c:
            raise ValueError(
                f"channels ({C}) not divisible by mesh['ch'] ({n_c})")
        return fn(pcm)

    return jax.jit(wrapped)


def metrics_summary(out):
    """Cross-channel metric reduction (detection rate, mean CFO, mean
    eq error) -- an all-reduce XLA lowers to a psum across the mesh."""
    detected = out.valid.sum()
    return {
        "packets_detected": detected,
        "mean_cfo_hz": jnp.where(
            detected > 0,
            jnp.sum(jnp.where(out.valid, out.cfo_hz, 0.0)) / detected, 0.0),
        "mean_eq_error": jnp.where(
            detected > 0,
            jnp.sum(jnp.where(out.valid, out.eq_error, 0.0)) / detected, 0.0),
    }
