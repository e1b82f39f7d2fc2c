"""singlecarrier_tpu: a batched single-carrier QPSK modem framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
C modem (srsampson/SingleCarrier): RRC
matched filtering, BPSK preamble correlation sync, square-root-Kalman
adaptive equalization, QPSK slicing and DVB descrambling -- built as
batched, shardable, jit-compiled pipelines that demodulate very large
channel counts concurrently.

Layer map (mirrors SURVEY.md):
  config           numerology (the reference's #define block)
  constants        PN preamble, RRC taps (regenerated), keystream
  filter_design    gen_rn_coeffs.m port
  dsp/             FIR, mixer, decimator, correlator, FFT/CFO
  adaptive/        sqrt-Kalman + equalizer scans; batch LS equalizer
  modem/           TX; faithful RX (bit-parity); production RX
  channel          AWGN/CFO/phase/timing impairments
  ber              BER-vs-SNR harness
  parallel/        mesh, channel-sharded and time-sharded demod
  runtime/         stream driver, checkpoint, metrics, native IO
  utils/           compile cache, small linalg
"""

from .config import DEFAULT_CONFIG, ModemConfig

__version__ = "0.1.0"

__all__ = ["ModemConfig", "DEFAULT_CONFIG", "__version__"]
