"""Time-sharded demodulation (sequence parallelism with halo exchange).

Splits ONE channel's long PCM stream across devices along the block
axis.  The only cross-block state in the signal chain (SURVEY.md
section 2 SP row) is:

 * the FIR delay line: ntaps-1 = 48 samples (fir.c:30-34),
 * the hunt window: the previous block's 376 decimated symbols
   (qpsk.c:160-161),
 * the mixer phasor: closed-form, exp(j w N k) per block -- computable
   locally from the global block index with NO communication.

So each shard needs a left halo of one raw PCM block plus 48 samples
(1928 samples total): it receives the halo from its left neighbor via
``ppermute`` (one interconnect hop), locally downmixes+filters it to rebuild
``decim_prev``/``fir_tail``, and then scans its own blocks.  This is
the overlap-save boundary design: redundant compute of one block per
shard buys exact seam-free results (verified by the seam tests:
1 device vs N devices, identical bits).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import ModemConfig
from ..constants import rrc_taps
from ..dsp.fir import fir_block, fir_init_state
from ..dsp.mixer import mix_block, mixer_table
from ..modem.rx_production import ProdRxState, prod_rx_stream


def _block_phase(cfg: ModemConfig, block_idx):
    """Mixer phasor at the start of block ``block_idx`` (closed form).

    The per-block phase advance is ``mixer_table(...)[N-1]``; the k-th
    block starts at phase advance^k.  Computed in float64 on the host
    table and exponentiated per-shard -- no neighbor communication.
    """
    w = -2.0 * np.pi * cfg.center / cfg.fs
    n = cfg.frame_size
    # Per-block angle advance reduced mod 2pi in float64 on the host, so
    # only k * (advance mod 2pi) is computed in float32 on device.
    ang = (w * n) % (2.0 * np.pi) * block_idx.astype(jnp.float32)
    return jnp.exp(1j * ang).astype(jnp.complex64)


def _rebuild_boundary_state(cfg: ModemConfig, halo, my_first_block,
                            is_first):
    """Reconstruct the ProdRxState at this shard's first block from the
    1928-sample left halo (previous block + its 48-sample FIR halo)."""
    n_sym = cfg.symbols_per_block
    taps = rrc_taps(cfg.alpha, cfg.ntaps)

    halo = jnp.where(is_first, jnp.zeros_like(halo), halo)
    x = halo.astype(jnp.float32) / cfg.tx_amplitude

    # Downmix with the correct absolute phase for block my_first_block-1,
    # position -48 samples relative to that block's start.
    prev_idx = jnp.maximum(my_first_block - 1, 0)
    phase0 = _block_phase(cfg, prev_idx)
    w = (-2.0 * np.pi * cfg.center / cfg.fs) % (2.0 * np.pi)
    pre_rot = jnp.exp(-1j * w * cfg.fir_halo).astype(jnp.complex64)
    raw, _ = mix_block(x, phase0 * pre_rot, -cfg.center, cfg.fs)

    # Overlap-save: the halo's first 48 samples seed the FIR delay line,
    # the remaining frame_size samples filter into the previous block's
    # symbols.
    fir_state = raw[..., :cfg.fir_halo]
    filtered, fir_tail = fir_block(taps, cfg.fir_gain, fir_state,
                                   raw[..., cfg.fir_halo:])
    decim_prev = filtered.reshape(n_sym, cfg.cycles).T

    return ProdRxState(
        phase=_block_phase(cfg, my_first_block),
        fir_tail=fir_tail,
        decim_prev=jnp.where(is_first, jnp.zeros_like(decim_prev),
                             decim_prev),
    )


def time_sharded_rx(cfg: ModemConfig, pcm_blocks, mesh: Mesh, *,
                    descramble: bool = True, axis: str = "time"):
    """Demodulate [n_blocks, frame_size] with the block axis sharded.

    ``n_blocks`` must divide evenly by the mesh's ``axis`` size.
    Returns ProdRxOut stacked over all blocks (gathered).
    """
    n_dev = mesh.shape[axis]
    n_blocks = pcm_blocks.shape[0]
    assert n_blocks % n_dev == 0, (n_blocks, n_dev)
    per = n_blocks // n_dev

    def shard_fn(pcm_local):
        # pcm_local: [per, frame_size]
        idx = lax.axis_index(axis)
        my_first = idx * per

        # Left halo: last block + preceding 48 samples of my local shard,
        # sent to the right neighbor.
        flat = pcm_local.reshape(-1)
        halo_out = flat[-(cfg.frame_size + cfg.fir_halo):]
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        halo_in = lax.ppermute(halo_out, axis, perm)

        state0 = _rebuild_boundary_state(cfg, halo_in, my_first,
                                         is_first=(idx == 0))
        _, out = prod_rx_stream(cfg, state0, pcm_local,
                                descramble=descramble)
        return out

    spec = P(axis)
    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    )
    return fn(pcm_blocks)


def make_time_sharded_rx(cfg: ModemConfig, mesh: Mesh, *,
                         descramble: bool = True, axis: str = "time"):
    return jax.jit(functools.partial(
        time_sharded_rx, cfg, mesh=mesh, descramble=descramble, axis=axis))


def grid_sharded_rx(cfg: ModemConfig, pcm, mesh: Mesh, *,
                    descramble: bool = True):
    """2D-sharded demodulation: channels on 'ch' x blocks on 'time'.

    ``pcm``: [n_channels, n_blocks, frame_size]; n_channels divisible
    by mesh.shape['ch'], n_blocks by mesh.shape['time'].  Combines the
    DP channel axis with the SP time axis: halos ride ``ppermute`` over
    the 'time' mesh dimension only (one interconnect hop), channels never
    communicate.
    """
    n_ch_dev = mesh.shape["ch"]
    n_t_dev = mesh.shape["time"]
    n_channels, n_blocks = pcm.shape[0], pcm.shape[1]
    assert n_channels % n_ch_dev == 0 and n_blocks % n_t_dev == 0
    per = n_blocks // n_t_dev

    def shard_fn(pcm_local):
        # pcm_local: [c_loc, per, frame_size]
        idx = lax.axis_index("time")
        my_first = idx * per

        flat = pcm_local.reshape(pcm_local.shape[0], -1)
        halo_out = flat[:, -(cfg.frame_size + cfg.fir_halo):]
        perm = [(i, i + 1) for i in range(n_t_dev - 1)]
        halo_in = lax.ppermute(halo_out, "time", perm)

        state0 = jax.vmap(
            lambda h: _rebuild_boundary_state(cfg, h, my_first,
                                              is_first=(idx == 0))
        )(halo_in)
        _, out = jax.vmap(
            lambda st, p: prod_rx_stream(cfg, st, p,
                                         descramble=descramble)
        )(state0, pcm_local)
        return out

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("ch", "time"),),
        out_specs=P("ch", "time"),
        check_vma=False,
    )
    return fn(pcm)


def make_grid_sharded_rx(cfg: ModemConfig, mesh: Mesh, *,
                         descramble: bool = True):
    return jax.jit(functools.partial(
        grid_sharded_rx, cfg, mesh=mesh, descramble=descramble))
