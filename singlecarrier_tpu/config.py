"""Modem numerology / configuration.

Re-design of the reference's compile-time ``#define`` block
(reference: headers/qpsk_internal.h:23-61, headers/fir.h:16-17,
headers/kalman.h:26, headers/scramble.h:16-17).  Every constant the C
code hardcodes becomes a validated field of a frozen dataclass whose
defaults are the reference values, so the whole pipeline stays
shape-static under ``jax.jit`` while remaining runtime-configurable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModemConfig:
    """Single-carrier QPSK modem numerology.

    Defaults reproduce the reference modem exactly
    (headers/qpsk_internal.h:23-61).
    """

    # Sampling / symbol rates -------------------------------------------------
    fs: float = 8000.0          # sample rate, Hz            (qpsk_internal.h:32)
    rs: float = 1600.0          # symbol rate, baud          (qpsk_internal.h:33)
    center: float = 1100.0      # carrier center, Hz         (qpsk_internal.h:37)

    # Framing -----------------------------------------------------------------
    ns: int = 8                 # data frames per packet     (qpsk_internal.h:39)
    data_symbols: int = 31      # symbols per data frame     (qpsk_internal.h:40)
    preamble_length: int = 128  # BPSK chips                 (qpsk_internal.h:53)

    # RRC matched filter ------------------------------------------------------
    ntaps: int = 49             # FIR taps                   (headers/fir.h:16)
    fir_gain: float = 2.2       # FIR output gain            (headers/fir.h:17)
    alpha: float = 0.35         # roll-off; reference default is the
                                # "narrow" filter (firwide=false, qpsk.c:60)
    rrc_nsym: int = 10          # filter span in symbols     (constants.c:46)

    # Adaptive equalizer / Kalman --------------------------------------------
    eq_length: int = 5          # equalizer taps             (qpsk_internal.h:30)
    kalman_E: float = 0.1       # measurement-error init     (kalman.c:61)
    kalman_q: float = 0.08      # process noise              (kalman.c:62)
    data_eq_error_gain: float = 0.1   # decision-directed error scaling
                                      # (equalizer.c:81)

    # Sync / detection --------------------------------------------------------
    fine_timing_offset: int = 3       # decimation phase     (qpsk_internal.h:23)
    match_threshold_margin: int = 30  # detect if matches > P-30 (qpsk.c:196)
    eof_cost_value: float = 5.0       # hunt-reentry cost    (qpsk_internal.h:28)

    # Production-RX extensions (no reference equivalent) ----------------------
    peak_gate: float = 7.0        # corr peak must exceed gate*window energy
                                  # (the reference's commented-out energy
                                  # gate, qpsk.c:196).  CHOSEN from the
                                  # measured Pfa/Pd sweep (DETECTION.md,
                                  # tools/detection_curves.py): 7.0 cuts
                                  # noise-only Pfa 1.0e-4 -> 3.8e-6 per
                                  # block with ZERO measured Pd change
                                  # at every SNR(2-8 dB) x CFO(0-40 Hz)
                                  # point for both bf16 and int8 hunts
                                  # (matches > match_threshold does the
                                  # detecting; the gate only suppresses
                                  # noise windows that fluke the chip-
                                  # sign test).  Pfa hits 0/524288 at
                                  # 8.0 if false alarms matter more
    corr_segments: int = 8        # non-coherent correlation segments
                                  # (CFO-tolerant hunt; 1 = reference's
                                  # coherent correlator)
    cfo_nfft: int = 512           # zero-padded FFT size for CFO search.
                                  # 512 (4x zero-pad of the 128 chips)
                                  # since round 5: at 2x pad (256) the
                                  # parabolic peak interpolation on
                                  # the |sinc|^2 mainlobe carries a
                                  # grid-fraction-dependent BIAS up to
                                  # ~0.4 Hz (measured at 35 Hz CFO
                                  # even at 20 dB SNR), whose phase
                                  # ramp across the 155 ms packet
                                  # exceeds the refine clamp and cost
                                  # 2.2 dB at the CFO edge: 35 Hz/4 dB
                                  # loss 3.01 -> 0.81 dB at 512 (bias
                                  # 0.39 -> 0.04 Hz; 1024 gains
                                  # nothing further)
    nlms_mu: float = 0.5          # production data-phase NLMS step size
    hunt_dtype: str = "bf16"      # correlation-hunt matmul operands
                                  # ("bf16" | "f32" | "int8"); peak
                                  # statistic only.  "int8" quantizes
                                  # the hunt windows (the PN band
                                  # matrix is +/-1/0 chips, exactly
                                  # int8) with exact int32
                                  # accumulation; its ~-40 dBc
                                  # quantization floor is far below the
                                  # detection statistic's noise at any
                                  # operating SNR.  round() makes
                                  # GATE-MARGINAL noise blocks
                                  # knife-edge sensitive to ulp-level
                                  # front-end differences, so two
                                  # front-ends can disagree on a
                                  # sub-threshold false detect; bf16
                                  # stays the default parity surface
                                  # (gates: tests/test_batch_rx.py)
    hunt_int8_scale: float = 16.0  # int8 hunt quantization step:
                                  # q = clip(round(x*scale), +/-127),
                                  # representable range +/-7.9 in
                                  # matched-filter output units (|x|
                                  # is ~O(1); clipping merely
                                  # saturates rare noise peaks, to
                                  # which the correlation is robust)
    hunt_norm: str = "espan"      # hunt argmax statistic ("espan" |
                                  # "energy" | "none").  "energy"
                                  # normalizes the segmented
                                  # correlation power by the per-lag
                                  # window energy before the argmax --
                                  # a CFAR-style normalized matched
                                  # filter.  Mechanism it fixes
                                  # (DETECTION.md): the DATA sections
                                  # transmit at 2x the preamble
                                  # amplitude (qpsk.c:313-319) so
                                  # their correlation sidelobes
                                  # out-compete the true peak once CFO
                                  # decoherence costs it ~2.4 dB -- at
                                  # 40 Hz the raw-power argmax missed
                                  # 8-21% of packets into mid-packet
                                  # sidelobes.  "espan" (default)
                                  # normalizes by the full-rate SPAN
                                  # energy shared across the cyc
                                  # decimation phases (the phase-summed
                                  # squared planes through ONE band
                                  # contraction): the same CFAR
                                  # mechanism with 5x the samples in
                                  # the denominator, identical Pd at
                                  # the CFO edge and identical noise
                                  # Pfa to "energy".  The final
                                  # peak>gate*energy criterion is
                                  # UNCHANGED (peak stays raw power at
                                  # the chosen lag).  "none" keeps the
                                  # raw-power argmax
    ls_reg: float = 1e-4          # ridge regularization of the LS eq fit
                                  # (CENTER tap; scale-aware, relative
                                  # to the Gram trace)
    ls_offtap_reg: float = 1.0    # EXTRA ridge on the off-center taps
                                  # of the TRAINING fit -- a shrinkage
                                  # prior toward the pure-delay
                                  # (1-tap) solution.  Measured
                                  # decomposition (round 5, 6 dB
                                  # AWGN): 0.8 dB of the pipeline's
                                  # 0.92 dB implementation loss was LS
                                  # estimation noise of 5 free taps
                                  # fitted on 128 quarter-power chips
                                  # (L=1 fit: 0.13 dB).  With
                                  # train=1.0/refit=0.1 the loss drops
                                  # to 0.29 dB on AWGN, 0.90->0.80 at
                                  # 0.5-sample delay, 3.17->2.76 at
                                  # 35 Hz CFO; cost on a HARSH echo
                                  # (1.4 symbols, -6 dB): ber 8e-4 ->
                                  # 1.3e-3 at 10 dB (channel.multipath
                                  # sweep).  Set == ls_reg to recover
                                  # the uniform-ridge (round<=4)
                                  # behavior
    ls_offtap_reg_refit: float = 0.1  # off-tap shrinkage of the
                                  # decision-directed REFIT: weaker --
                                  # 248 full-power symbols can afford
                                  # real off-taps, so the data largely
                                  # overrides the prior on genuine
                                  # multipath while keeping most of
                                  # the AWGN denoising
    phase_refine_iters: int = 3   # GUARDED decision-directed
                                  # phase-ramp passes (each applied
                                  # only where the decision error
                                  # drops; see ls_equalizer.
                                  # phase_refine)
    ls_refit_iters: int = 1       # decision-directed LS refit passes
    ls_refit_symbols: int = 0     # refit window: fit the decision-
                                  # directed refit on only the FIRST
                                  # this-many data symbols (0 = the
                                  # full ns*data_symbols section).
                                  # The refit's Gram/b-vector/apply
                                  # work scales with the window.
                                  # Quality measured (317k bits/pt,
                                  # Wilson CIs): 128 is loss-free on
                                  # every axis -- AWGN 2/4/6 dB equal
                                  # within CIs, 35 Hz CFO edge equal,
                                  # harsh echo (1.4 sym/-6 dB at
                                  # 10 dB) 3.3e-4 vs 3.4e-4; 64 costs
                                  # ~0.1 dB AWGN, ~12% more errors at
                                  # the CFO edge and 1.7x the echo
                                  # errors.  Library default 0 keeps
                                  # the full-window behavior
    frac_timing: bool = False     # sub-sample timing recovery: parabolic
                                  # interpolation of the correlation peak
                                  # + 2-tap fractional-delay blend at
                                  # packet extraction.  Off by default:
                                  # at 5x oversampling the symbol-spaced
                                  # LS equalizer absorbs sub-sample
                                  # timing (measured: eq error and BER
                                  # flat vs injected fractional delay);
                                  # enable for low-oversampling configs
                                  # (fs/rs <= 2) where the residual
                                  # matters

    # Scrambler ---------------------------------------------------------------
    scramble_seed: int = 0x4A80       # DVB LFSR sync seed   (scramble.h:16)

    # TX levels ---------------------------------------------------------------
    tx_amplitude: float = 16384.0     # data int16 scale     (qpsk.c:317)
    preamble_amplitude: float = 8192.0  # preamble at 50%    (qpsk.c:315)
    inter_packet_gap: int = 903       # zero samples between packets
                                      # (qpsk.c:410-412)

    # ------------------------------------------------------------------ derived
    @property
    def cycles(self) -> int:
        """Oversampling factor FS/RS (qpsk_internal.h:35)."""
        return int(self.fs / self.rs)

    @property
    def ts(self) -> float:
        return 1.0 / self.rs

    @property
    def frame_symbols(self) -> int:
        return self.data_symbols * self.ns

    @property
    def data_size(self) -> int:
        """Samples of data per packet (qpsk_internal.h:45)."""
        return self.data_symbols * self.cycles * self.ns

    @property
    def preamble_size(self) -> int:
        """Samples of preamble per packet (qpsk_internal.h:54)."""
        return self.preamble_length * self.cycles

    @property
    def frame_size(self) -> int:
        """Samples per RX processing block (qpsk_internal.h:48)."""
        return self.preamble_size + self.data_size

    @property
    def bits_per_frame(self) -> int:
        """Payload bits per packet (qpsk_internal.h:51)."""
        return self.data_symbols * 2 * self.ns

    @property
    def symbols_per_block(self) -> int:
        """Decimated symbols per RX block (FRAME_SIZE / CYCLES)."""
        return self.frame_size // self.cycles

    @property
    def match_threshold(self) -> int:
        """Minimum trained-chip sign matches for detect (qpsk.c:196)."""
        return self.preamble_length - self.match_threshold_margin

    @property
    def effective_peak_gate(self) -> float:
        """Segment-normalized detection gate (what the receivers apply).

        The clean-signal correlation peak/energy ratio equals the
        SEGMENT LENGTH P/n_seg (each segment's coherent gain: peak =
        sum_s 2|corr_s|^2 ~ 2*P*seg*a^2 over energy 2*P*a^2), so a
        fixed gate silently couples to ``corr_segments`` -- at
        n_seg=32 (4-chip segments) the clean ratio is 4 and a gate of
        7 rejects every true packet.  Normalized so ``peak_gate``
        keeps its DETECTION.md-calibrated meaning at the default
        16-chip segments: effective = peak_gate * (P/n_seg) / 16.
        Identity at the default numerology (128/8 = 16).
        """
        return self.peak_gate * (
            self.preamble_length / self.corr_segments) / 16.0

    @property
    def packet_size(self) -> int:
        """Total samples per packet incl. inter-packet gap (qpsk.c:380-413)."""
        return self.frame_size + self.inter_packet_gap

    @property
    def fir_halo(self) -> int:
        """Carried FIR state: NTAPS-1 samples (fir.c:30-34)."""
        return self.ntaps - 1

    @property
    def pkt_window(self) -> int:
        """Aligned packet-extraction window (production RX).

        Covers eq left margin + preamble + all data symbols + eq right
        margin = P + D + L - 1 symbols, rounded up for layout.  For a
        preamble at the very last searchable lag the final eq window's
        forward margin is clamped (stale by <= 1 symbol) -- affects
        1/376 of stream positions' last data symbol only.
        """
        need = (self.preamble_length + self.frame_symbols
                + self.eq_length - 1)
        return -(-need // 8) * 8

    def __post_init__(self) -> None:
        if self.fs <= 0 or self.rs <= 0:
            raise ValueError("fs and rs must be positive")
        if self.fs % self.rs != 0:
            raise ValueError(
                f"fs ({self.fs}) must be an integer multiple of rs ({self.rs})"
            )
        if self.ntaps % 2 != 1:
            raise ValueError("ntaps must be odd (linear-phase RRC)")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if self.eq_length < 1:
            raise ValueError("eq_length must be >= 1")
        if self.fine_timing_offset < 0 or self.fine_timing_offset >= self.cycles:
            raise ValueError("fine_timing_offset must be in [0, cycles)")
        if not 0 <= self.scramble_seed < (1 << 15):
            raise ValueError("scramble_seed must fit in 15 bits")
        if self.inter_packet_gap < 0:
            raise ValueError("inter_packet_gap must be >= 0")
        # Production-RX hunt invariants (modem/rx_production.py _hunt):
        # one argmax is taken per block, which is only exhaustive if at
        # most ONE preamble can start within any frame_size span of the
        # stream.  packet_size = frame_size + gap >= frame_size
        # guarantees that for gap >= 0 (asserted above); the preamble
        # must also fit inside the 2-block hunt window at the largest
        # searchable lag, i.e. preamble_length <= symbols_per_block.
        if self.hunt_dtype not in ("bf16", "f32", "int8"):
            raise ValueError(
                f"hunt_dtype must be bf16|f32|int8, got {self.hunt_dtype}")
        if self.hunt_int8_scale <= 0:
            raise ValueError("hunt_int8_scale must be positive")
        if self.hunt_norm not in ("energy", "espan", "none"):
            raise ValueError(
                f"hunt_norm must be energy|espan|none, got "
                f"{self.hunt_norm}")
        if not 0 <= self.ls_refit_symbols <= self.frame_symbols:
            raise ValueError(
                f"ls_refit_symbols must be in [0, "
                f"{self.frame_symbols}], got {self.ls_refit_symbols}")
        if self.ls_offtap_reg < 0 or self.ls_offtap_reg_refit < 0:
            raise ValueError("ls_offtap_reg(_refit) must be >= 0")
        if self.preamble_length > self.symbols_per_block:
            raise ValueError(
                f"preamble_length ({self.preamble_length}) must be <= "
                f"symbols_per_block ({self.symbols_per_block}): the "
                "single-peak-per-block hunt cannot contain the preamble "
                "in its 2-block window at the last searchable lag")

    def replace(self, **kw) -> "ModemConfig":
        return dataclasses.replace(self, **kw)


# The reference modem's exact numerology.
DEFAULT_CONFIG = ModemConfig()
