"""BER-vs-SNR harness tests (BASELINE.json config #3)."""

import jax
import numpy as np
import pytest

from singlecarrier_tpu.ber import ber_run, ber_sweep, qpsk_theory_ber
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG


@pytest.fixture(scope="module")
def sweep():
    return ber_sweep(CFG, [2.0, 6.0, 12.0], key=jax.random.PRNGKey(5),
                     n_packets=4, n_trials=3)


def test_ber_monotonic_in_snr(sweep):
    bers = [p["ber"] for p in sweep]
    assert bers[0] >= bers[1] >= bers[2]


def test_high_snr_near_zero(sweep):
    assert sweep[-1]["ber"] < 1e-3
    assert sweep[-1]["detection_rate"] == 1.0


def test_low_snr_detects(sweep):
    # 2 dB passband SNR ~ 9 dB Eb/N0: preamble detection should hold
    assert sweep[0]["detection_rate"] >= 0.75


def test_theory_anchor(sweep):
    """Measured BER within 0.5 dB of the coherent QPSK theory curve.

    Measured implementation loss is < 0.3 dB across 2-6 dB passband
    SNR and 0-35 Hz CFO since the GUARDED phase refinement landed
    (unguarded refinement iterations accumulated estimator noise worth
    0.6-1.0 dB; see adaptive/ls_equalizer.phase_refine).  The residual
    is the LS-estimation noise of 128 half-amplitude training chips,
    mostly recovered by the decision-directed refit.
    """
    p = sweep[1]   # 6 dB passband
    worse = qpsk_theory_ber(p["ebn0_db"] - 0.5)[0]
    assert p["ber"] <= worse + 0.02, (p, worse)


def test_clean_channel_zero_ber():
    p = ber_run(CFG, jax.random.PRNGKey(6), snr_db=None, n_packets=3,
                n_trials=1)
    assert p["ber"] == 0.0
    assert p["detection_rate"] == 1.0


def test_theory_curve_values():
    # Q(sqrt(2*Eb/N0)) spot checks
    assert abs(qpsk_theory_ber(0.0)[0] - 0.0786) < 1e-3
    assert abs(qpsk_theory_ber(9.6)[0] - 1.0e-5) < 5e-6


def test_ber_fused_paths_clean():
    """The block-parallel batch core decodes a clean channel error-free
    through ber_run (trials ride its channel axis), as the scan oracle
    does."""
    for path in ("batch", "xla"):
        p = ber_run(CFG, jax.random.PRNGKey(8), snr_db=None,
                    n_packets=2, n_trials=2, path=path)
        assert p["ber"] == 0.0, path
        assert p["detection_rate"] == 1.0, path


def test_implementation_loss_small_and_echo_capability():
    """The off-tap shrinkage prior (config.ls_offtap_reg): ~0.8 dB of
    implementation loss was LS estimation noise of 5 free taps on an
    ISI-free channel (L=1 fit: 0.13 dB); the prior recovers most of it
    (measured 0.92 -> 0.29 dB at 6 dB) while the equalizer still
    handles a real echo (the capability the off-taps exist for)."""
    import math

    p = ber_run(CFG, jax.random.PRNGKey(42), snr_db=6.0,
                n_packets=10, n_trials=8)
    # loss < 0.45 dB: theory at (ebn0 - 0.45) must upper-bound measured
    worse = qpsk_theory_ber(p["ebn0_db"] - 0.45)[0]
    assert p["ber"] <= worse, (p["ber"], worse, p["ebn0_db"])

    # 0.8-symbol passband echo at -8 dB: decodes cleanly at 8 dB
    pe = ber_run(CFG, jax.random.PRNGKey(42), snr_db=8.0,
                 n_packets=6, n_trials=4, echoes=((4, 0.4),))
    assert pe["detection_rate"] == 1.0
    assert pe["ber"] < 0.01, pe["ber"]
