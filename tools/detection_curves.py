#!/usr/bin/env python
"""Detector operating-point characterization: Pfa / Pd curves.

The reference's energy gate is commented out (reference:
src/qpsk.c:196); the production RX added ``cfg.peak_gate`` without a
committed characterization.  This tool
measures, on hardware:

  * false-alarm probability per block on pure noise (Pfa), with
    Wilson 95% intervals, and
  * detection probability on real modulated packets (Pd) across
    SNR x CFO,

for hunt_dtype in {bf16, int8} and a SWEEP of gate values.  The batch
core returns the raw statistics (peak, energy, matches), so one run
per (stream, dtype) evaluates every gate value host-side with the
receiver's exact criterion: valid = (peak > energy*gate) &
(matches > match_threshold).  Measured through the batch core
(prod_rx_batch), the path bench.py times.

``--segments`` sweeps ``cfg.corr_segments`` (the CFO tolerance /
noise-averaging tradeoff of the segmented non-coherent hunt) over the
Pd grid -- the knob that attacks the 40 Hz CFO floor
with: 16-chip segments (n_seg=8) lose ~2.4 dB of correlation power at
40 Hz (coherent-integration loss sinc^2(f*T_seg)), 8-chip segments
(n_seg=16) only ~0.6 dB.

Writes the JSON report and the markdown summary (``--out``/``--md``).
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json


GATES = [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0]


def _wilson(k: int, n: int, z: float = 1.96):
    # single source of truth for CI math across committed artifacts
    from singlecarrier_tpu.ber import _wilson_ci
    return _wilson_ci(k, n, z)


def main() -> int:
    ap = argparse.ArgumentParser()
    # 65536 x 16 = 1,048,576 noise blocks = the bench dispatch size:
    # at Pfa ~1e-5 that is ~13 events, enough for a meaningful CI at
    # the shipped gate (a 524288-block run left
    # gate-7/8 Pfa with 1-2 events)
    ap.add_argument("--noise-channels", type=int, default=65536)
    ap.add_argument("--noise-blocks", type=int, default=16)
    ap.add_argument("--pd-channels", type=int, default=256)
    ap.add_argument("--pd-packets", type=int, default=6)
    ap.add_argument("--snrs", default="2,3,4,5,6,8")
    ap.add_argument("--cfos", default="0,20,40")
    ap.add_argument("--segments", default=None,
                    help="comma list of corr_segments values to sweep "
                         "over the Pd grid (e.g. 8,16,32); adds a "
                         "high-CFO segment-sweep section")
    ap.add_argument("--hunt-norm", default=None,
                    choices=[None, "energy", "espan", "none"],
                    help="override cfg.hunt_norm for every RX config "
                         "(A/B the argmax statistic before flipping "
                         "the default)")
    ap.add_argument("--seg-cfos", default="30,40,50",
                    help="CFO grid for the --segments sweep")
    ap.add_argument("--seg-snrs", default="2,4,6",
                    help="SNR grid for the --segments sweep")
    ap.add_argument("--out", default="DETECTION.json")
    ap.add_argument("--md", default="DETECTION.md")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from singlecarrier_tpu.channel import channel
    from singlecarrier_tpu.config import DEFAULT_CONFIG
    from singlecarrier_tpu.modem import (prod_rx_init_planes, tx_stream)
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch

    BASE = (DEFAULT_CONFIG if not args.hunt_norm
            else DEFAULT_CONFIG.replace(hunt_norm=args.hunt_norm))
    dev = jax.devices()[0]
    report = {"device": f"{dev.platform} {dev.device_kind}",
              "match_threshold": DEFAULT_CONFIG.match_threshold,
              "hunt_norm": BASE.hunt_norm,
              "gates": GATES, "pfa": {}, "pd": {}}

    def run_stats(cfg, pcm_frames):
        """-> (peak, energy, matches, lag, phase) numpy arrays [B, C]."""
        C = pcm_frames.shape[1]

        @jax.jit
        def step(pcm):
            st = prod_rx_init_planes(cfg, C)
            _, out = prod_rx_batch(cfg, st, pcm)
            return (out.peak, out.energy, out.matches, out.lag,
                    out.timing_phase)
        return [np.asarray(x) for x in step(pcm_frames)]

    # ---------------- Pfa on pure noise ----------------
    # Identical synthesis to bench.py's noise stream (random.bits +
    # bitcast, >>1 for the +-16384 convention; per-block lax.map keeps
    # the u32 intermediate at 1/B of the stream) so the measured Pfa
    # is directly comparable to the bench's own false-detect count.
    from jax import lax

    B, C = args.noise_blocks, args.noise_channels
    for hd in ("bf16", "int8"):
        cfg = BASE.replace(hunt_dtype=hd)

        @jax.jit
        def noise(key):
            def one(k):
                u = jax.random.bits(k, (C, cfg.frame_size // 2),
                                    jnp.uint32)
                x = lax.bitcast_convert_type(u, jnp.int16).reshape(
                    C, cfg.frame_size)
                return (x >> 1).astype(jnp.int16)
            return lax.map(one, jax.random.split(key, B))

        peak, energy, matches, _, _ = run_stats(
            cfg, noise(jax.random.PRNGKey(7)))
        n_blocks = peak.size
        row = {}
        for g in GATES:
            fa = int(((peak > energy * g)
                      & (matches > cfg.match_threshold)).sum())
            lo, hi = _wilson(fa, n_blocks)
            row[str(g)] = {"false_alarms": fa, "blocks": n_blocks,
                           "pfa": fa / n_blocks,
                           "pfa_ci95": [lo, hi]}
        report["pfa"][hd] = row
        print("pfa", hd, {g: r["pfa"] for g, r in row.items()},
              flush=True)

    # ---------------- Pd on real packets ----------------
    snrs = [float(s) for s in args.snrs.split(",")]
    cfos = [float(f) for f in args.cfos.split(",")]
    Cp, P = args.pd_channels, args.pd_packets
    cfgs = {hd: BASE.replace(hunt_dtype=hd)
            for hd in ("bf16", "int8")}
    rng = np.random.default_rng(123)
    bits = rng.integers(
        0, 2, (Cp, P, DEFAULT_CONFIG.ns,
               DEFAULT_CONFIG.data_symbols * 2), dtype=np.uint8)

    import functools

    # freq_hz is STATIC (channel() branches on it in Python; one
    # compile per CFO value, snr rides traced through awgn)
    @functools.partial(jax.jit, static_argnames=("freq_hz",))
    def make_stream(bits_dev, key, snr_db, freq_hz):
        cfg = DEFAULT_CONFIG
        pcm = tx_stream(cfg, bits_dev, flush_gap=True, scramble=True)
        n_blocks = -(-pcm.shape[-1] // cfg.frame_size) + 1
        pad = n_blocks * cfg.frame_size - pcm.shape[-1]
        x = jnp.pad(pcm.astype(jnp.float32), ((0, 0), (0, pad)))
        keys = jax.random.split(key, Cp)
        x = jax.vmap(lambda k, s: channel(
            k, s, snr_db=snr_db, freq_hz=freq_hz,
            fs=cfg.fs))(keys, x)
        x = x.astype(jnp.int16).reshape(Cp, -1, cfg.frame_size)
        return jnp.swapaxes(x, 0, 1)                   # [B, Cp, n]

    cfgd = DEFAULT_CONFIG
    for hd in ("bf16", "int8"):
        report["pd"][hd] = {}
        for snr in snrs:
            for f in cfos:
                pcm = make_stream(jnp.asarray(bits),
                                  jax.random.PRNGKey(1),
                                  jnp.float32(snr), float(f))
                peak, energy, matches, lag, ph = run_stats(cfgs[hd],
                                                           pcm)
                nb = peak.shape[0]
                row = {}
                for g in GATES:
                    valid = ((peak > energy * g)
                             & (matches > cfgd.match_threshold))
                    # position-matched true-packet accounting
                    det = 0
                    spur = 0
                    for c in range(Cp):
                        assigned = {}
                        for fr in np.nonzero(valid[:, c])[0]:
                            pos = ((int(fr) - 1) * cfgd.frame_size
                                   + int(lag[fr, c]) * cfgd.cycles
                                   + int(ph[fr, c]))
                            p = int(round(pos / cfgd.packet_size))
                            perr = abs(pos - p * cfgd.packet_size)
                            if (not 0 <= p < P
                                    or perr > cfgd.packet_size // 4):
                                spur += 1
                                continue
                            if p in assigned:
                                spur += 1
                            else:
                                assigned[p] = fr
                        det += len(assigned)
                    row[str(g)] = {
                        "detected": det, "expected": Cp * P,
                        "pd": det / (Cp * P), "spurious": spur}
                report["pd"][hd][f"snr{snr}_cfo{f}"] = row
                print("pd", hd, snr, f,
                      {g: round(r["pd"], 4) for g, r in row.items()},
                      flush=True)

    # ---------------- corr_segments sweep at high CFO ----------------
    def pd_at(cfg, pcm):
        """Position-matched Pd at the SHIPPED gate for one config
        (effective = segment-normalized; config.effective_peak_gate)."""
        peak, energy, matches, lag, ph = run_stats(cfg, pcm)
        valid = ((peak > energy * cfg.effective_peak_gate)
                 & (matches > cfg.match_threshold))
        det = 0
        spur = 0
        for c in range(Cp):
            assigned = {}
            for fr in np.nonzero(valid[:, c])[0]:
                pos = ((int(fr) - 1) * cfg.frame_size
                       + int(lag[fr, c]) * cfg.cycles
                       + int(ph[fr, c]))
                p = int(round(pos / cfg.packet_size))
                perr = abs(pos - p * cfg.packet_size)
                if not 0 <= p < P or perr > cfg.packet_size // 4:
                    spur += 1
                    continue
                if p in assigned:
                    spur += 1
                else:
                    assigned[p] = fr
            det += len(assigned)
        return det, spur

    if args.segments:
        segs = [int(s) for s in args.segments.split(",")]
        seg_snrs = [float(s) for s in args.seg_snrs.split(",")]
        seg_cfos = [float(f) for f in args.seg_cfos.split(",")]
        report["segment_sweep"] = {
            "segments": segs, "snrs": seg_snrs, "cfos": seg_cfos,
            "hunt_dtype": "int8", "gate": DEFAULT_CONFIG.peak_gate,
            "pd": {}, "pfa": {}}
        for s in segs:
            scfg = BASE.replace(
                hunt_dtype="int8", corr_segments=s)
            # noise Pfa at the effective (segment-normalized) gate --
            # shorter segments may discriminate noise differently, so
            # the Pd gain must be priced in Pfa too
            Bn = max(2, args.noise_blocks // 4)

            @jax.jit
            def noise_s(key):
                def one(k):
                    u = jax.random.bits(
                        k, (C, scfg.frame_size // 2), jnp.uint32)
                    x = lax.bitcast_convert_type(
                        u, jnp.int16).reshape(C, scfg.frame_size)
                    return (x >> 1).astype(jnp.int16)
                return lax.map(one, jax.random.split(key, Bn))

            pk, en, mt, _, _ = run_stats(scfg,
                                         noise_s(jax.random.PRNGKey(7)))
            fa = int(((pk > en * scfg.effective_peak_gate)
                      & (mt > scfg.match_threshold)).sum())
            lo, hi = _wilson(fa, pk.size)
            report["segment_sweep"]["pfa"][str(s)] = {
                "false_alarms": fa, "blocks": int(pk.size),
                "pfa": fa / pk.size, "pfa_ci95": [lo, hi],
                "effective_gate": scfg.effective_peak_gate}
            print("seg-pfa", s, fa, "/", pk.size, flush=True)
            for snr in seg_snrs:
                for f in seg_cfos:
                    pcm = make_stream(jnp.asarray(bits),
                                      jax.random.PRNGKey(1),
                                      jnp.float32(snr), float(f))
                    det, spur = pd_at(scfg, pcm)
                    key = f"seg{s}_snr{snr}_cfo{f}"
                    lo, hi = _wilson(det, Cp * P)
                    report["segment_sweep"]["pd"][key] = {
                        "detected": det, "expected": Cp * P,
                        "pd": det / (Cp * P), "pd_ci95": [lo, hi],
                        "spurious": spur}
                    print("seg", s, snr, f,
                          round(det / (Cp * P), 4), flush=True)

    with open(args.out, "w") as fo:
        json.dump(report, fo, indent=1)

    # ---------------- DETECTION.md ----------------
    pathdesc = "the batch core (prod_rx_batch, the path bench.py times)"
    lines = [
        "# Detector operating point (measured on hardware)",
        "",
        f"Device: {report['device']}.  Measured through {pathdesc} "
        f"at `hunt_norm=\"{report['hunt_norm']}\"`.  "
        "Criterion: "
        "`valid = (corr_peak > gate * window_energy) & "
        f"(matches > {report['match_threshold']})` -- the energy gate "
        "the reference comments out (qpsk.c:196) plus its match "
        "threshold.  One run per (stream, hunt dtype) evaluates every "
        "gate from the receiver's returned statistics.",
        "",
        "## False-alarm probability per block (pure noise, "
        f"{args.noise_channels * args.noise_blocks} blocks, "
        "bench-identical synthesis; Wilson 95% CI)",
        "",
        "| gate | " + " | ".join(f"Pfa {hd}" for hd in report["pfa"])
        + " |",
        "|---|" + "---|" * len(report["pfa"]),
    ]
    for g in GATES:
        cells = []
        for hd in report["pfa"]:
            r = report["pfa"][hd][str(g)]
            lo, hi = r.get("pfa_ci95", (0, 0))
            cells.append(f"{r['pfa']:.2e} ({r['false_alarms']}; "
                         f"CI {lo:.1e}-{hi:.1e})")
        lines.append(f"| {g} | " + " | ".join(cells) + " |")
    lines += [
        "",
        "## Detection probability (position-matched true packets, "
        f"{args.pd_channels * args.pd_packets} packets/point)",
        "",
    ]
    for hd in report["pd"]:
        lines += [f"### hunt_dtype = {hd}", "",
                  "| SNR dB | CFO Hz | " +
                  " | ".join(f"g={g}" for g in GATES) + " |",
                  "|---|---|" + "---|" * len(GATES)]
        for snr in snrs:
            for f in cfos:
                row = report["pd"][hd][f"snr{snr}_cfo{f}"]
                cells = [f"{row[str(g)]['pd']:.3f}" for g in GATES]
                lines.append(f"| {snr} | {f} | " + " | ".join(cells)
                             + " |")
        lines.append("")
    if "segment_sweep" in report:
        ss = report["segment_sweep"]
        lines += [
            "## corr_segments sweep at high CFO "
            f"(hunt int8, base gate {ss['gate']} segment-normalized "
            "to config.effective_peak_gate; Wilson 95% CI)",
            "",
            "Shorter segments tolerate more CFO (coherent-integration "
            "loss sinc^2(f*T_seg): 16-chip segments lose ~2.4 dB at "
            "40 Hz, 8-chip ~0.6 dB) at the cost of non-coherent "
            "combining loss and a wider hunt band matrix "
            "(throughput cost not measured).  "
            "n_seg=32 (4-chip segments) DEGENERATES: the statistic "
            "loses discrimination against the full-amplitude random "
            "data symbols and the argmax lands on data-driven "
            "sidelobes even on a clean channel (0/3 clean detections, "
            "measured on CPU) -- excluded from the on-chip sweep.",
            "",
            "Noise Pfa at each segment count's effective gate: " +
            ", ".join(
                f"n_seg={s}: {r['pfa']:.2e} ({r['false_alarms']}/"
                f"{r['blocks']}, gate {r['effective_gate']:g})"
                for s, r in ss.get("pfa", {}).items()) + ".",
            "",
            "| SNR dB | CFO Hz | " +
            " | ".join(f"n_seg={s}" for s in ss["segments"]) + " |",
            "|---|---|" + "---|" * len(ss["segments"]),
        ]
        for snr in ss["snrs"]:
            for f in ss["cfos"]:
                cells = []
                for s in ss["segments"]:
                    r = ss["pd"][f"seg{s}_snr{snr}_cfo{f}"]
                    cells.append(f"{r['pd']:.3f}")
                lines.append(f"| {snr} | {f} | " + " | ".join(cells)
                             + " |")
        lines.append("")
    cfgd_now = DEFAULT_CONFIG
    lines += [
        "## Chosen operating point",
        "",
        f"`peak_gate = {cfgd_now.peak_gate}` / `corr_segments = "
        f"{cfgd_now.corr_segments}` (config.py defaults): read the "
        f"g={cfgd_now.peak_gate:g} column row-by-row.  Raising the "
        "gate trades residual noise false alarms against low-SNR "
        "detection margin; the curves above make that trade explicit "
        "per hunt dtype.  This characterization and the bench's own "
        "false-detect count come from the same receiver and the same "
        "noise synthesis, so the bench's observed rate must sit "
        "inside the Pfa CI of its gate row.",
        "",
    ]
    with open(args.md, "w") as fo:
        fo.write("\n".join(lines))
    print("wrote", args.out, "and", args.md)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
