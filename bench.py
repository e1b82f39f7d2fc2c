#!/usr/bin/env python
"""Throughput benchmark: batched production demod samples/s per card.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "detail": {...}}

``detail`` names the device (platform, device_kind, count) and the
card's power limit.  The input stream is synthesized ON DEVICE
(jax.random) so host->device transfer is excluded; the file-fed path
is measured by tools/ingest_bench.py.  Refuses to run without an
accelerator.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _card() -> str:
    """``nvidia-smi`` name and power limit of the card, or "unknown"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=None,
                    help="default: 8192 (production modes), 1024 "
                         "(faithful modes)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="blocks per dispatch; default: 128 "
                         "(production), 8 otherwise")
    ap.add_argument("--iters", type=int, default=16,
                    help="timed chained steps")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--hunt-dtype", default="int8",
                    choices=["bf16", "f32", "int8"],
                    help="cfg.hunt_dtype for the production modes")
    ap.add_argument("--refit-symbols", type=int, default=128,
                    help="cfg.ls_refit_symbols for the production modes "
                         "(0 = full data section)")
    ap.add_argument("--real-stream", action="store_true",
                    help="synthesize REAL modulated packet streams "
                         "(every channel detecting) instead of noise")
    ap.add_argument("--mode",
                    choices=["production", "production-scan", "faithful",
                             "faithful-blocked"],
                    default="production",
                    help="production = block-parallel batch core; "
                         "production-scan = K-block super-steps over "
                         "the core; faithful = reference-exact "
                         "Kalman-scan RX; faithful-blocked = blocked "
                         "Kalman restructuring (adaptive/blocked_rls.py)")
    ap.add_argument("--kalman-block", type=int, default=32,
                    help="faithful-blocked block size B")
    ap.add_argument("--superstep", type=int, default=1,
                    help="production-scan: blocks per super-step K")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    if jax.devices()[0].platform == "cpu":
        raise SystemExit("bench.py measures an accelerator; JAX found "
                         "only the CPU")

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    production = args.mode.startswith("production")
    if production:
        cfg = cfg.replace(hunt_dtype=args.hunt_dtype,
                          ls_refit_symbols=args.refit_symbols)
    C = args.channels or (8192 if production else 1024)
    B = args.blocks or (128 if args.mode == "production" else 8)

    if args.real_stream:
        from singlecarrier_tpu.modem import tx_stream

        # A packet every packet_size samples, so nearly every block's
        # hunt window holds a preamble; `uniq` distinct channels tiled.
        uniq = min(C, 256)
        n_pkts = max(1, (B * cfg.frame_size) // cfg.packet_size)

        @jax.jit
        def synth(key):
            bits = jax.random.randint(
                key, (uniq, n_pkts, cfg.ns, cfg.data_symbols * 2),
                0, 2, jnp.uint8)
            pcm = tx_stream(cfg, bits, flush_gap=True, scramble=True)
            need = B * cfg.frame_size
            x = jnp.pad(pcm, ((0, 0), (0, max(0, need - pcm.shape[-1])))
                        )[:, :need]
            x = jnp.tile(x, (C // uniq, 1)).reshape(C, B, cfg.frame_size)
            return jnp.swapaxes(x, 0, 1).astype(jnp.int16)
    else:
        @jax.jit
        def synth(key):
            # [B, C, n] int16 noise, one block at a time (random.bits +
            # bitcast: randint would hold u32 at 2x the stream)
            def one(k):
                u = jax.random.bits(k, (C, cfg.frame_size // 2),
                                    jnp.uint32)
                x = lax.bitcast_convert_type(u, jnp.int16).reshape(
                    C, cfg.frame_size)
                return (x >> 1).astype(jnp.int16)
            return lax.map(one, jax.random.split(key, B))

    def summary(out, err):
        return (out.valid.sum().astype(jnp.float32) + err.sum(),
                out.valid.sum())

    if not production:
        from singlecarrier_tpu.modem.rx import rx_init, rx_stream
        kb = args.kalman_block if args.mode == "faithful-blocked" else 0

        @jax.jit
        def step(state, pcm):
            st, out = jax.vmap(
                lambda s, p: rx_stream(cfg, s, p, blocked=kb)
            )(state, jnp.swapaxes(pcm, 0, 1))
            return st, summary(out, out.eof_cost)

        state = rx_init(cfg, (C,))
    else:
        from singlecarrier_tpu.modem import prod_rx_init_planes
        from singlecarrier_tpu.modem.rx_production import (
            prod_rx_batch, prod_rx_stream_superstep)

        def demod(state, pcm):
            if args.mode == "production":
                st, out = prod_rx_batch(cfg, state, pcm)
            else:
                st, out = prod_rx_stream_superstep(
                    cfg, state, pcm, superstep=args.superstep)
            return st, summary(out, out.eq_error)

        # the carried state is donated: the chained carry aliases in
        # place instead of holding input+output state live at once
        step = jax.jit(demod, donate_argnums=(0,))
        state = prod_rx_init_planes(cfg, C)

    pcm = synth(jax.random.PRNGKey(0))
    t_c = time.perf_counter()
    for _ in range(args.warmup):
        state, (chk, nv) = step(state, pcm)
    jax.block_until_ready((state, chk))
    warm_s = time.perf_counter() - t_c

    # Timed iterations chain asynchronously (each step consumes the
    # previous state) and end in one block_until_ready.
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, (chk, nv) = step(state, pcm)
    jax.block_until_ready((state, chk, nv))
    dt = time.perf_counter() - t0

    sps = C * B * cfg.frame_size * args.iters / dt
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"{args.mode}_demod_samples_per_sec_per_card",
        "value": sps,
        "unit": "samples/s",
        "detail": {
            "channels": C,
            "blocks_per_iter": B,
            "iters": args.iters,
            "wall_s": dt,
            "warmup_s": warm_s,
            "equivalent_realtime_8khz_channels": int(sps / cfg.fs),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": _card(),
            "hunt_dtype": cfg.hunt_dtype,
            "stream": "real_packets" if args.real_stream else "noise",
            "detected_blocks_last_iter": int(nv),
        },
    }))


if __name__ == "__main__":
    main()
