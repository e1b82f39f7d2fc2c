"""Command-line interface.

The reference shipped an unused header-only option parser
(reference: headers/optparse.h, zero include sites -- SURVEY.md C13)
and hardcoded everything at compile time.  This CLI wires the intended
runtime surface: modulate, demodulate, loopback, BER sweeps, and the
throughput benchmark, with every numerology constant overridable.

Usage:
  python -m singlecarrier_tpu mod --out /tmp/tx.raw --packets 10
  python -m singlecarrier_tpu demod --in /tmp/tx.raw
  python -m singlecarrier_tpu loopback --packets 10
  python -m singlecarrier_tpu ber --snrs 0,2,4,6,8
  python -m singlecarrier_tpu info
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .config import DEFAULT_CONFIG, ModemConfig


def _add_cfg_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fs", type=float, default=DEFAULT_CONFIG.fs)
    p.add_argument("--rs", type=float, default=DEFAULT_CONFIG.rs)
    p.add_argument("--center", type=float, default=DEFAULT_CONFIG.center)
    p.add_argument("--alpha", type=float, default=DEFAULT_CONFIG.alpha)
    p.add_argument("--ns", type=int, default=DEFAULT_CONFIG.ns)
    p.add_argument("--eq-length", type=int,
                   default=DEFAULT_CONFIG.eq_length)
    p.add_argument("--hunt-dtype", default=DEFAULT_CONFIG.hunt_dtype,
                   choices=["bf16", "f32", "int8"])
    p.add_argument("--hunt-norm", default=DEFAULT_CONFIG.hunt_norm,
                   choices=["energy", "espan", "none"])
    p.add_argument("--refit-iters", type=int,
                   default=DEFAULT_CONFIG.ls_refit_iters)
    p.add_argument("--refit-symbols", type=int,
                   default=DEFAULT_CONFIG.ls_refit_symbols)
    p.add_argument("--refine-iters", type=int,
                   default=DEFAULT_CONFIG.phase_refine_iters)


def _cfg_from(args) -> ModemConfig:
    return DEFAULT_CONFIG.replace(
        fs=args.fs, rs=args.rs, center=args.center, alpha=args.alpha,
        ns=args.ns, eq_length=args.eq_length,
        hunt_dtype=args.hunt_dtype, hunt_norm=args.hunt_norm,
        ls_refit_iters=args.refit_iters,
        ls_refit_symbols=args.refit_symbols,
        phase_refine_iters=args.refine_iters)


def cmd_info(args) -> int:
    cfg = _cfg_from(args)
    import jax
    print(json.dumps({
        "config": {f: getattr(cfg, f) for f in (
            "fs", "rs", "center", "alpha", "ns", "data_symbols",
            "preamble_length", "ntaps", "eq_length")},
        "derived": {
            "cycles": cfg.cycles, "frame_size": cfg.frame_size,
            "bits_per_frame": cfg.bits_per_frame,
            "packet_size": cfg.packet_size,
        },
        "devices": [str(d) for d in jax.devices()],
    }, indent=2))
    return 0


def cmd_mod(args) -> int:
    import jax.numpy as jnp

    from .modem import tx_stream

    cfg = _cfg_from(args)
    rng = np.random.default_rng(args.seed)
    bits = rng.integers(0, 2, (args.packets, cfg.ns,
                               cfg.data_symbols * 2), dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits),
                               scramble=args.scramble,
                               flush_gap=not args.reference_gap))
    pcm.astype("<i2").tofile(args.out)
    if args.bits_out:
        np.save(args.bits_out, bits)
    print(f"wrote {len(pcm)} samples ({args.packets} packets) to "
          f"{args.out}", file=sys.stderr)
    return 0


def cmd_demod(args) -> int:
    import jax
    import jax.numpy as jnp

    cfg = _cfg_from(args)
    pcm = np.fromfile(getattr(args, "in"), dtype="<i2")
    n = -(-len(pcm) // cfg.frame_size) + 1
    buf = np.zeros(n * cfg.frame_size, np.int16)
    buf[:len(pcm)] = pcm
    frames = jnp.asarray(buf.reshape(n, cfg.frame_size))

    if args.mode == "faithful":
        from .modem import make_rx_stream_fn, rx_init
        fn = make_rx_stream_fn(cfg, freq_offset=args.freq_offset)
        _, out = fn(rx_init(cfg), frames)
        out = jax.tree.map(np.asarray, out)
        for fr in np.nonzero(out.valid)[0]:
            print(json.dumps({
                "frame": int(fr),
                "max_index": int(out.max_index[fr]),
                "matches": int(out.matches[fr]),
                "bits": "".join(map(str, out.bits[fr])),
            }))
    else:
        from .modem import make_prod_rx_fn, prod_rx_init
        fn = make_prod_rx_fn(cfg, descramble=args.descramble)
        _, out = fn(prod_rx_init(cfg), frames)
        out = jax.tree.map(np.asarray, out)
        for fr in np.nonzero(out.valid)[0]:
            rec = {
                "frame": int(fr),
                "lag": int(out.lag[fr]),
                "timing_phase": int(out.timing_phase[fr]),
                "matches": int(out.matches[fr]),
                "cfo_hz": round(float(out.cfo_hz[fr]), 2),
                "eq_error": round(float(out.eq_error[fr]), 4),
                "bits": "".join(map(str, out.bits[fr])),
            }
            print(json.dumps(rec))
    print(f"{int(out.valid.sum())} packets detected in {n} blocks",
          file=sys.stderr)
    return 0


def cmd_loopback(args) -> int:
    import jax
    import jax.numpy as jnp

    from .modem import make_prod_rx_fn, prod_rx_init, tx_stream

    cfg = _cfg_from(args)
    rng = np.random.default_rng(args.seed)
    bits = rng.integers(0, 2, (args.packets, cfg.ns,
                               cfg.data_symbols * 2), dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits), scramble=True,
                               flush_gap=True))
    if args.snr is not None or args.cfo:
        from .channel import channel
        pcm = np.asarray(channel(
            jax.random.PRNGKey(args.seed), jnp.asarray(pcm),
            snr_db=args.snr, freq_hz=args.cfo, fs=cfg.fs))
    n = -(-len(pcm) // cfg.frame_size) + 1
    buf = np.zeros(n * cfg.frame_size, np.float32)
    buf[:len(pcm)] = pcm
    fn = make_prod_rx_fn(cfg, descramble=True)
    _, out = fn(prod_rx_init(cfg),
                jnp.asarray(buf.reshape(n, cfg.frame_size)))
    out = jax.tree.map(np.asarray, out)
    got = out.bits[out.valid]
    ref = bits.reshape(args.packets, cfg.bits_per_frame)
    k = min(len(got), len(ref))
    ber = float(np.mean(got[:k] != ref[:k])) if k else 1.0
    print(json.dumps({
        "packets_sent": args.packets,
        "packets_detected": int(out.valid.sum()),
        "ber": ber,
        "mean_cfo_hz": float(out.cfo_hz[out.valid].mean()) if k else None,
    }))
    return 0


def cmd_ber(args) -> int:
    import jax

    from .ber import ber_sweep, qpsk_theory_ber

    cfg = _cfg_from(args)
    snrs = [float(s) for s in args.snrs.split(",")]
    pts = ber_sweep(cfg, snrs, key=jax.random.PRNGKey(args.seed),
                    n_packets=args.packets, n_trials=args.trials,
                    freq_hz=args.cfo, path=args.path)
    for p in pts:
        p["theory_ber"] = float(qpsk_theory_ber(p["ebn0_db"])[0])
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in p.items()}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="singlecarrier_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print config + devices")
    _add_cfg_flags(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("mod", help="modulate packets to a PCM file")
    _add_cfg_flags(p)
    p.add_argument("--out", required=True)
    p.add_argument("--bits-out", default=None)
    p.add_argument("--packets", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scramble", action="store_true")
    p.add_argument("--reference-gap", action="store_true",
                   help="reference-faithful unflushed inter-packet gap")
    p.set_defaults(fn=cmd_mod)

    p = sub.add_parser("demod", help="demodulate a PCM file")
    _add_cfg_flags(p)
    p.add_argument("--in", required=True)
    p.add_argument("--descramble", action="store_true", default=False)
    p.add_argument("--mode", choices=["production", "faithful"],
                   default="production",
                   help="faithful = bit-parity with the C reference")
    p.add_argument("--freq-offset", type=float, default=0.0,
                   help="faithful-mode RX carrier offset (FOFFSET)")
    p.set_defaults(fn=cmd_demod)

    p = sub.add_parser("loopback", help="TX->channel->RX self test")
    _add_cfg_flags(p)
    p.add_argument("--packets", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr", type=float, default=None)
    p.add_argument("--cfo", type=float, default=0.0)
    p.set_defaults(fn=cmd_loopback)

    p = sub.add_parser("ber", help="BER-vs-SNR sweep")
    _add_cfg_flags(p)
    p.add_argument("--snrs", default="0,2,4,6,8,10")
    p.add_argument("--packets", type=int, default=6)
    p.add_argument("--trials", type=int, default=4)
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", default="xla", choices=["xla", "batch"],
                   help="demod path under test: the per-block scan "
                        "oracle or the block-parallel batch core")
    p.set_defaults(fn=cmd_ber)

    args = ap.parse_args(argv)
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
