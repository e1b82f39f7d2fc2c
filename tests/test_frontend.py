"""Batched front-end (dsp/frontend.frontend_planes) vs the per-block
mixer + FIR oracle with its carried phase and halo."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlecarrier_tpu.config import DEFAULT_CONFIG
from singlecarrier_tpu.dsp.fir import fir_block
from singlecarrier_tpu.dsp.frontend import frontend_planes
from singlecarrier_tpu.dsp.mixer import mix_block
from singlecarrier_tpu.constants import rrc_taps
from singlecarrier_tpu.modem.rx_production import _block_seeds, prod_rx_init


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("alpha", [0.35, 0.50])
def test_frontend_planes_matches_mix_and_fir(alpha, B):
    """B blocks x 2 channels of random PCM: the closed-form seeds plus
    ONE batched band matmul equal the sequential mix_block + fir_block
    chain (carry threaded block to block), decimated by reshape."""
    cfg = DEFAULT_CONFIG.replace(alpha=alpha)
    C = 2
    rng = np.random.default_rng(int(alpha * 100) + B)
    pcm = rng.integers(-16384, 16384, (B, C, cfg.frame_size)
                       ).astype(np.int16)
    # a non-trivial carried state entering block 0
    st = prod_rx_init(cfg, (C,))
    st = st._replace(
        phase=jnp.exp(1j * jnp.asarray([0.3, -1.1])).astype(jnp.complex64),
        fir_tail=jnp.asarray(rng.normal(size=(C, cfg.ntaps - 1))
                             .astype(np.complex64) * (0.5 + 0.25j)))

    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    want = []
    phase, tail = st.phase, st.fir_tail
    for b in range(B):
        x = jnp.asarray(pcm[b]).astype(jnp.float32) / cfg.tx_amplitude
        raw, phase = mix_block(x, phase, -cfg.center, cfg.fs)
        y, tail = fir_block(taps, cfg.fir_gain, tail, raw)
        d = np.asarray(y).reshape(C, cfg.symbols_per_block, cfg.cycles)
        want.append(np.stack([d.real, d.imag], -2).transpose(0, 3, 2, 1))
    want = np.stack(want)                        # [B, C, cyc, 2, n_sym]

    @jax.jit
    def batched(pcm):
        ph_r, ph_i, t_r, t_i = _block_seeds(
            cfg, pcm, st.phase.real, st.phase.imag, st.fir_tail.real,
            st.fir_tail.imag)
        n, halo = cfg.frame_size, cfg.ntaps - 1
        return frontend_planes(
            cfg, pcm.reshape(B * C, n), ph_r.reshape(-1),
            ph_i.reshape(-1), t_r.reshape(B * C, halo),
            t_i.reshape(B * C, halo))

    got = np.asarray(batched(jnp.asarray(pcm))).reshape(want.shape)
    assert got.shape == (B, C, cfg.cycles, 2, cfg.symbols_per_block)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
