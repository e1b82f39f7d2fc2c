#!/usr/bin/env python
"""On-card smoke test of the production receiver.

    python chip_smoke.py             # one card: phases 1-7
    python chip_smoke.py --cards 4   # four cards: the sharded paths only

Runs in ONE process through the normal entry points and refuses to run
without a GPU.  Phases (one card):

  1. device: ``jax.devices()``, device kind, ``nvidia-smi`` name and
     power limit;
  2. faithful parity: modem/rx.py on the frozen fixture stream against
     the C reference's decisions (tests/golden/reference.npz);
  3. the batch core against the per-block scan oracle at full width:
     4,096 channels x 8 blocks, each channel with its own CFO, SNR and
     timing offset, half carrying packets and half noise;
  4. scale: 262,144 channels x 4 blocks per dispatch, two chained
     dispatches with the state donated, every 64th channel carrying
     12 dB packets; detection, BER, false detects, samples/s, memory;
  5. the gated two-phase receiver against the core at detection
     density 1e-2, with its capacity sized from steady-state gate
     hits;
  6. file-fed: interleaved PCM file -> PcmDispatchSource ->
     PrefetchIngest -> feed -> the core, against the in-memory run;
  7. the CLI: loopback clean and impaired, mod -> demod.

With ``--cards 4``: the channel-sharded core on a 4-card mesh and the
2D [ch=2 x time=2] grid, each against the single-card core on the same
PCM.  Every phase prints its checks; the last line of a passing run is
``{"ok": true, "device": {...}}``.  A failing run exits non-zero and
prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Operating point of the scale phase (bench.py defaults).
SCALE_HUNT_DTYPE = "int8"
SCALE_REFIT_SYMBOLS = 128


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def require_gpu(min_count: int = 1):
    """The devices, or SystemExit when JAX finds no GPU (no fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < min_count:
        raise SystemExit(
            f"chip_smoke needs {min_count} GPU(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)")
    return devs


# ---------------------------------------------------------------------------
# Synthesis (on device, from a seed)


def synth_channels(cfg, key, n_ch, n_blocks, *, n_pkts, carriers, snr_db,
                   cfo_hz, offsets):
    """[n_blocks, n_ch, frame_size] int16 passband PCM.

    Channel c carries ``n_pkts`` packets (starting at sample
    ``offsets[c]``, CFO ``cfo_hz[c]``) where ``carriers[c]``, else
    silence; AWGN at ``snr_db[c]`` relative to the packet power goes on
    every channel.  Returns (pcm, bits [n_ch, n_pkts, bits_per_frame],
    the noise standard deviation).
    """
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.channel import apply_cfo_phase, awgn, timing_offset
    from singlecarrier_tpu.modem import tx_stream

    total = n_blocks * cfg.frame_size
    kb, kn = jax.random.split(key)
    bits = jax.random.randint(
        kb, (n_ch, n_pkts, cfg.ns, cfg.data_symbols * 2), 0, 2, jnp.uint8)
    tx = tx_stream(cfg, bits, flush_gap=True, scramble=True)
    tx = jnp.pad(tx.astype(jnp.float32),
                 ((0, 0), (0, max(0, total - tx.shape[-1]))))[:, :total]
    active = jnp.abs(tx) > 0
    power = jnp.sum(tx * tx) / jnp.sum(active)
    x = jax.vmap(timing_offset)(tx, offsets)
    x = jax.vmap(lambda s, f: apply_cfo_phase(s, f, 0.0, cfg.fs))(x, cfo_hz)
    x = jnp.where(carriers[:, None], x, 0.0)
    keys = jax.random.split(kn, n_ch)
    x = jax.vmap(lambda k, s, snr: awgn(k, s, snr, signal_power=power))(
        keys, x, snr_db)
    pcm = jnp.clip(jnp.round(x), -32768, 32767).astype(jnp.int16)
    sigma = jnp.sqrt(power / 10.0 ** (snr_db / 10.0))
    return (jnp.swapaxes(pcm.reshape(n_ch, n_blocks, cfg.frame_size), 0, 1),
            bits.reshape(n_ch, n_pkts, cfg.bits_per_frame), sigma)


def preamble_blocks(cfg, n_blocks, offsets, carriers, n_pkts):
    """[B, C] bool: block b's hunt range holds a transmitted preamble
    (its start, delayed ntaps-1 by the TX+RX filters, falls in
    [(b-1)*n, b*n))."""
    n = cfg.frame_size
    held = np.zeros((n_blocks, len(offsets)), bool)
    for c in np.nonzero(carriers)[0]:
        for p in range(n_pkts):
            s = offsets[c] + p * cfg.packet_size + cfg.ntaps - 1
            b = s // n + 1
            if b < n_blocks:
                held[b, c] = True
    return held


def compare_decisions(got, ref, held, *, noise_ratio=1e-4):
    """Check ``got`` against the oracle's ``ref`` ([B, C] ProdRxOut of
    numpy arrays).

    valid, and lag / timing_phase / bits of detected blocks, must be
    identical, except on gate-marginal blocks that hold no preamble: at
    most one per 1/noise_ratio such blocks.  On blocks valid in both,
    cfo_hz agrees within 0.05 Hz and eq_error within relative 1e-3;
    where lag and phase agree, peak agrees within relative 1e-3.
    Returns (ok, report dict).
    """
    either = got.valid | ref.valid
    bad = got.valid != ref.valid
    bad |= either & ((got.lag != ref.lag)
                     | (got.timing_phase != ref.timing_phase))
    both = got.valid & ref.valid
    bad |= both & np.any(got.bits != ref.bits, axis=-1)
    noise_blocks = int((~held).sum())
    allowed = int(noise_blocks * noise_ratio)
    same_peak = (got.lag == ref.lag) & (got.timing_phase == ref.timing_phase)

    def rel(a, b):
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)

    rep = {
        "blocks": int(got.valid.size),
        "detected_core": int(got.valid.sum()),
        "detected_oracle": int(ref.valid.sum()),
        "mismatch_preamble_blocks": int((bad & held).sum()),
        "mismatch_noise_blocks": int((bad & ~held).sum()),
        "allowed_noise_mismatches": allowed,
        "lag_differs_on_undetected": int(
            (~either & (got.lag != ref.lag)).sum()),
        "max_cfo_diff_hz": float(np.max(np.abs(
            got.cfo_hz - ref.cfo_hz)[both], initial=0.0)),
        "max_eq_error_rel": float(np.max(rel(
            got.eq_error, ref.eq_error)[both], initial=0.0)),
        "max_peak_rel": float(np.max(rel(got.peak, ref.peak)[same_peak],
                                     initial=0.0)),
    }
    ok = (rep["mismatch_preamble_blocks"] == 0
          and rep["mismatch_noise_blocks"] <= allowed
          and rep["max_cfo_diff_hz"] <= 0.05
          and rep["max_eq_error_rel"] <= 1e-3
          and rep["max_peak_rel"] <= 1e-3)
    return ok, rep


def oracle(cfg, pcm):
    """The per-block scan oracle on [B, C, n] PCM, vmapped over channels
    at HIGHEST default matmul precision; [B, C] numpy leaves."""
    import jax

    from singlecarrier_tpu.modem import prod_rx_init, prod_rx_stream

    fn = jax.jit(jax.vmap(
        lambda p: prod_rx_stream(cfg, prod_rx_init(cfg), p)[1]))
    with jax.default_matmul_precision("highest"):
        out = fn(jax.numpy.swapaxes(pcm, 0, 1))
    return jax.tree.map(lambda x: np.swapaxes(np.asarray(x), 0, 1), out)


def match_packets(cfg, out, bits, offsets, channels):
    """Position-match detections of packet channels to sent packets.

    ``out``: [B, C'] numpy ProdRxOut rows of ``channels``; ``bits``:
    [C', n_pkts, bits_per_frame].  Returns (detected, sent, bit errors,
    bits compared, unmatched detections)."""
    n = cfg.frame_size
    n_pkts = bits.shape[1]
    detected = errors = compared = unmatched = 0
    for j, c in enumerate(channels):
        found = set()
        for b in np.nonzero(out.valid[:, j])[0]:
            pos = ((b - 1) * n + int(out.lag[b, j]) * cfg.cycles
                   + int(out.timing_phase[b, j]))
            p = int(round((pos - offsets[c] - (cfg.ntaps - 1))
                          / cfg.packet_size))
            start = offsets[c] + p * cfg.packet_size + cfg.ntaps - 1
            if 0 <= p < n_pkts and abs(pos - start) <= cfg.cycles \
                    and p not in found:
                found.add(p)
                errors += int((out.bits[b, j] != bits[j, p]).sum())
                compared += bits.shape[-1]
            else:
                unmatched += 1
        detected += len(found)
    return detected, len(channels) * n_pkts, errors, compared, unmatched


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Phases


def phase_faithful(log):
    """Faithful modem/rx.py on the fixture stream vs the C reference."""
    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem import make_rx_stream_fn, rx_init

    g = np.load(ROOT / "tests" / "golden" / "reference.npz")
    pcm = g["tx_pcm"]
    nf = len(pcm) // cfg.frame_size
    frames = pcm[:nf * cfg.frame_size].reshape(nf, cfg.frame_size)
    _, out = make_rx_stream_fn(cfg)(rx_init(cfg), frames)
    out = _np(out)
    valid = g["rxt_valid"].astype(bool)
    checks = {
        "valid": np.array_equal(out.valid.astype(np.int32), g["rxt_valid"]),
        "max_index": np.array_equal(out.max_index, g["rxt_max_index"]),
        "matches": np.array_equal(out.matches, g["rxt_matches"]),
        "max_value": np.allclose(out.max_value, g["rxt_max_value"],
                                 rtol=1e-3, atol=1e-3),
        "mean": np.allclose(out.mean, g["rxt_mean"], rtol=1e-3, atol=1e-3),
        "bits": np.array_equal(out.bits[valid], g["rxt_bits"][valid]),
    }
    log(f"frames={nf} detected={int(out.valid.sum())} checks={checks}")
    return all(checks.values())


def phase_core_vs_oracle(log, *, channels=4096, blocks=8, seed=3):
    """The batch core against the scan oracle at full width."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch

    rng = np.random.default_rng(seed)
    n_pkts = max(1, (blocks - 2) * cfg.frame_size // cfg.packet_size)
    carriers = np.arange(channels) % 2 == 0
    offsets = rng.integers(0, cfg.packet_size, channels)
    cfo = rng.uniform(-30.0, 30.0, channels).astype(np.float32)
    snr = rng.uniform(4.0, 12.0, channels).astype(np.float32)
    pcm, _, _ = jax.jit(lambda k: synth_channels(
        cfg, k, channels, blocks, n_pkts=n_pkts,
        carriers=jnp.asarray(carriers), snr_db=jnp.asarray(snr),
        cfo_hz=jnp.asarray(cfo), offsets=jnp.asarray(offsets)))(
            jax.random.PRNGKey(seed))

    _, got = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p))(
        prod_rx_init_planes(cfg, channels), pcm)
    got = _np(got)
    ref = oracle(cfg, pcm)
    held = preamble_blocks(cfg, blocks, offsets, carriers, n_pkts)
    ok, rep = compare_decisions(got, ref, held)
    log("precision: front-end matmul f32 HIGHEST; hunt "
        f"{cfg.hunt_dtype} operands, f32 accumulate; energy band, LS "
        "fits and chip scores f32 HIGHEST; CFO search f32 FFT; oracle "
        "under default_matmul_precision('highest')")
    det = got.valid & carriers[None, :]
    err = np.abs(got.cfo_hz - cfo[None, :])[det]
    log(f"CFO error against the channel's true offset over {err.size} "
        f"detections: mean {float(err.mean()):.4f} Hz, max "
        f"{float(err.max()):.4f} Hz")
    log(f"{channels} ch x {blocks} blocks, {int(held.sum())} preamble "
        f"blocks: {json.dumps(rep)}")
    return ok


def phase_scale(log, *, channels=262144, blocks=4, every=64, seed=5,
                sampled=1024):
    """Two chained, state-donated dispatches at one card's share of
    the 1M-channel target."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch

    cfg = DEFAULT_CONFIG.replace(hunt_dtype=SCALE_HUNT_DTYPE,
                                 ls_refit_symbols=SCALE_REFIT_SYMBOLS)
    n = cfg.frame_size
    total_blocks = 2 * blocks
    n_pkts = max(1, (total_blocks - 2) * n // cfg.packet_size)
    rng = np.random.default_rng(seed)
    pk_ch = np.arange(0, channels, every)
    n_pk = len(pk_ch)
    offsets = np.zeros(channels, np.int64)
    offsets[pk_ch] = rng.integers(0, cfg.packet_size, n_pk)
    cfo = rng.uniform(-30.0, 30.0, n_pk).astype(np.float32)

    @jax.jit
    def synth(key):
        kp, kn = jax.random.split(key)
        pk, bits, sigma = synth_channels(
            cfg, kp, n_pk, total_blocks, n_pkts=n_pkts,
            carriers=jnp.ones(n_pk, bool),
            snr_db=jnp.full(n_pk, 12.0, jnp.float32),
            cfo_hz=jnp.asarray(cfo),
            offsets=jnp.asarray(offsets[pk_ch]))

        # the other channels: noise at the packet channels' level,
        # one block at a time
        def one(k):
            x = jax.random.normal(k, (channels, n), jnp.float32)
            return jnp.clip(jnp.round(x * sigma[0]), -32768,
                            32767).astype(jnp.int16)
        noise = jax.lax.map(one, jax.random.split(kn, total_blocks))
        return noise.at[:, pk_ch].set(pk), bits

    t0 = time.perf_counter()
    pcm, bits = synth(jax.random.PRNGKey(seed))
    pcm_a, pcm_b = pcm[:blocks], pcm[blocks:]
    del pcm
    jax.block_until_ready((pcm_a, pcm_b))
    log(f"synthesized {pcm_a.nbytes * 2 / 1e9:.3f} GB int16 PCM in "
        f"{time.perf_counter() - t0:.1f} s")

    step = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p),
                   donate_argnums=(0,))
    state = prod_rx_init_planes(cfg, channels)
    t0 = time.perf_counter()
    compiled = step.lower(state, pcm_a).compile()
    log(f"compiled in {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")

    t0 = time.perf_counter()
    state, out_a = compiled(state, pcm_a)
    state, out_b = compiled(state, pcm_b)
    jax.block_until_ready((state, out_a, out_b))
    wall = time.perf_counter() - t0
    samples = 2 * blocks * channels * n
    log(f"2 dispatches x {blocks} blocks x {channels} ch: wall {wall:.4f} "
        f"s, {samples / wall:.6e} samples/s "
        f"({samples / wall / cfg.fs:.0f} real-time 8 kHz channels)")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    finite = bool(all(bool(jnp.all(jnp.isfinite(x))) for x in
                      (out_a.peak, out_a.eq_error, out_a.cfo_hz,
                       out_b.peak, out_b.eq_error, out_b.cfo_hz)))
    def take(cols):
        return _np(jax.jit(lambda a, b: jax.tree.map(
            lambda x, y: jnp.concatenate([x[:, cols], y[:, cols]]),
            a, b))(out_a, out_b))

    pk_out = take(pk_ch)
    det, sent, err, compared, unmatched = match_packets(
        cfg, pk_out, np.asarray(bits), offsets, pk_ch)
    # false detects on noise channels, per block of the stream (block 0
    # is the fresh stream's first, whose previous-block half is silence)
    per_block = (np.concatenate([np.asarray(out_a.valid.sum(axis=1)),
                                 np.asarray(out_b.valid.sum(axis=1))])
                 - pk_out.valid.sum(axis=1))
    noise_false = int(per_block.sum())
    noise_ch = channels - n_pk
    pd = det / sent
    ber = err / max(compared, 1)
    log(f"packets detected {det}/{sent} (Pd {pd:.6f}), payload BER "
        f"{ber:.3e} ({err}/{compared} bits), false detects: "
        f"{noise_false} on noise channels + {unmatched} unmatched on "
        f"packet channels")
    log(f"noise-channel false detects per block {per_block.tolist()}: "
        f"{noise_false} in {total_blocks * noise_ch} noise block-channels "
        f"({noise_false / (total_blocks * noise_ch):.3e}); block 0 "
        f"{int(per_block[0])}, blocks 1-{total_blocks - 1} "
        f"{int(per_block[1:].sum())} in {(total_blocks - 1) * noise_ch} "
        f"({per_block[1:].sum() / ((total_blocks - 1) * noise_ch):.3e})")

    # sampled channels against the oracle over both dispatches
    pick = np.concatenate([pk_ch[:sampled // 2],
                           np.arange(1, channels, every)[:sampled // 2]])
    full = jnp.concatenate([pcm_a[:, pick], pcm_b[:, pick]])
    ref = oracle(cfg, full)
    got = take(pick)
    held = preamble_blocks(cfg, total_blocks, offsets[pick],
                           np.isin(pick, pk_ch), n_pkts)
    ok_cmp, rep = compare_decisions(got, ref, held)
    log(f"{len(pick)} sampled channels vs oracle: {json.dumps(rep)}")
    return finite and pd >= 0.99 and ber <= 1e-4 and ok_cmp


def phase_gated(log, *, channels=4096, blocks=12, dispatch=4, every=8,
                seed=7):
    """prod_rx_batch_gated against the core at density ~1e-2.

    The fresh stream's first dispatch fires the energy gate far more
    often than later ones (block 0's previous-block half is silence),
    so it runs with a capacity that cannot overflow (one row per
    block-channel) and is reported on its own.  The steady-state
    capacity K is sized from the gate hits of dispatch 1 (4x, rounded
    up to 128) and then holds dispatches 1 and 2.
    """
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem import (prod_rx_batch_gated,
                                         prod_rx_gated_init,
                                         prod_rx_init_planes)
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch

    rng = np.random.default_rng(seed)
    carriers = np.arange(channels) % every == 0
    offsets = rng.integers(0, (blocks - 2) * cfg.frame_size
                           - cfg.packet_size, channels)
    pcm, _, _ = jax.jit(lambda k: synth_channels(
        cfg, k, channels, blocks, n_pkts=1,
        carriers=jnp.asarray(carriers),
        snr_db=jnp.full(channels, 10.0, jnp.float32),
        cfo_hz=jnp.asarray(rng.uniform(-30, 30, channels), jnp.float32),
        offsets=jnp.asarray(offsets)))(jax.random.PRNGKey(seed))
    parts = [pcm[d:d + dispatch] for d in range(0, blocks, dispatch)]
    core = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p))
    st = prod_rx_init_planes(cfg, channels)
    outs = []
    for p in parts:
        st, o = core(st, p)
        outs.append(_np(o))
    full = jax.tree.map(lambda *x: np.concatenate(x), *outs)
    n_valid = int(full.valid.sum())

    def gated_fn(K):
        return jax.jit(lambda s, p: prod_rx_batch_gated(
            cfg, s, p, max_detections=K))

    def rows_of(g, b_off):
        rows = bad = 0
        for i in np.nonzero(g["valid"])[0]:
            b = int(g["block_idx"][i]) + b_off
            c = int(g["channel_idx"][i])
            rows += 1
            bad += not (full.valid[b, c]
                        and np.array_equal(g["bits"][i], full.bits[b, c])
                        and int(g["lag"][i]) == int(full.lag[b, c])
                        and int(g["timing_phase"][i])
                        == int(full.timing_phase[b, c])
                        and int(g["matches"][i]) == int(full.matches[b, c]))
        return rows, bad

    k_first = dispatch * channels
    first = gated_fn(k_first)
    gs0, g0 = first(prod_rx_gated_init(cfg, channels), parts[0])
    g0 = _np(g0)
    _, probe = first(gs0, parts[1])
    steady_hits = int(probe["count"])
    K = max(128, -(-4 * steady_hits // 128) * 128)
    steady = gated_fn(K)
    counts = [int(g0["count"])]
    rows, bad = rows_of(g0, 0)
    gs = gs0
    for d in range(1, len(parts)):
        gs, g = steady(gs, parts[d])
        g = _np(g)
        counts.append(int(g["count"]))
        r, x = rows_of(g, d * dispatch)
        rows += r
        bad += x
    density = n_valid / full.valid.size
    log(f"density {density:.3e}: core {n_valid} detections, gated "
        f"{rows} rows ({bad} differ); gate hits per dispatch {counts} "
        f"of {dispatch * channels} block-channels; first dispatch "
        f"(fresh stream) at capacity {k_first}, steady state at K={K} "
        f"(4x the {steady_hits} gate hits of dispatch 1)")
    return rows == n_valid and bad == 0 and max(counts[1:]) <= K


def phase_file_fed(log, *, channels=4096, blocks=4, dispatches=2, seed=9):
    """File -> PcmDispatchSource -> PrefetchIngest -> feed -> core."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch
    from singlecarrier_tpu.runtime.ingest import (PcmDispatchSource,
                                              PrefetchIngest, feed)

    subprocess.run(["make", "-s", "-C", str(ROOT / "native")],
                   check=True)
    rng = np.random.default_rng(seed)
    total = blocks * dispatches
    carriers = np.arange(channels) % 4 == 0
    pcm, _, _ = jax.jit(lambda k: synth_channels(
        cfg, k, channels, total,
        n_pkts=max(1, (total - 2) * cfg.frame_size // cfg.packet_size),
        carriers=jnp.asarray(carriers),
        snr_db=jnp.full(channels, 12.0, jnp.float32),
        cfo_hz=jnp.zeros(channels, jnp.float32),
        offsets=jnp.asarray(rng.integers(0, cfg.packet_size, channels))))(
            jax.random.PRNGKey(seed))
    host = np.asarray(pcm)                              # [B, C, n]
    core = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p))

    st = prod_rx_init_planes(cfg, channels)
    mem = []
    for d in range(dispatches):
        st, o = core(st, jnp.asarray(host[d * blocks:(d + 1) * blocks]))
        mem.append(_np(o))

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "stream.raw")
        # sample-major interleave: sample s of channel c at s*C + c
        np.ascontiguousarray(np.swapaxes(host, 1, 2)).tofile(path)
        src = PcmDispatchSource(path, channels, cfg.frame_size, blocks)
        try:
            ingest = PrefetchIngest(src, dispatches, depth=1)
            fed = []

            def step(s, dev):
                s, o = core(s, dev)
                fed.append(o)
                return s, o.valid.sum()

            t0 = time.perf_counter()
            _, chk = feed(ingest, jnp.asarray, step,
                          prod_rx_init_planes(cfg, channels))
            jax.block_until_ready(chk)
            wall = time.perf_counter() - t0
        finally:
            src.close()
    same = all(
        np.array_equal(a.valid, b.valid) and np.array_equal(a.bits, b.bits)
        and np.array_equal(a.lag, b.lag)
        for a, b in zip(mem, [_np(o) for o in fed]))
    log(f"{dispatches} dispatches x {blocks} blocks x {channels} ch from "
        f"file in {wall:.3f} s; {int(sum(m.valid.sum() for m in mem))} "
        f"detections; identical to in-memory: {same}")
    return same and len(fed) == dispatches


def phase_cli(log, *, packets=10):
    """loopback (clean, impaired) and mod -> demod through cli.main."""
    from singlecarrier_tpu.cli import main as cli

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        return rc, buf.getvalue()

    rc, out = run(["loopback", "--packets", str(packets)])
    clean = json.loads(out)
    log(f"loopback: {out.strip()}")
    ok = (rc == 0 and clean["packets_detected"] == packets
          and clean["ber"] == 0.0)
    rc2, out = run(["loopback", "--packets", str(packets), "--snr", "10",
                    "--cfo", "25"])
    log(f"loopback --snr 10 --cfo 25: {out.strip()}")
    ok &= rc2 == 0
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        raw = os.path.join(tmp, "tx.raw")
        bits = os.path.join(tmp, "bits.npy")
        rc3, _ = run(["mod", "--out", raw, "--bits-out", bits,
                      "--packets", str(packets)])
        rc4, out = run(["demod", "--in", raw])
        sent = np.load(bits).reshape(packets, -1)
    recs = [json.loads(line) for line in out.strip().splitlines()]
    got = [np.frombuffer(r["bits"].encode(), np.uint8) - ord("0")
           for r in recs]
    decoded = (len(got) == packets
               and all(np.array_equal(g, s) for g, s in zip(got, sent)))
    log(f"mod -> demod: {len(recs)} packets, all bits equal: {decoded}")
    return ok and rc3 == 0 and rc4 == 0 and decoded


def phase_four_cards(log, *, channels=262144, blocks=4, seed=11):
    """Channel-sharded core and the 2D grid against one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from singlecarrier_tpu.config import DEFAULT_CONFIG
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch
    from singlecarrier_tpu.parallel import (make_grid_batch_rx, make_mesh,
                                        make_sharded_batch_rx,
                                        shard_plane_state)

    cfg = DEFAULT_CONFIG.replace(hunt_dtype=SCALE_HUNT_DTYPE,
                                 ls_refit_symbols=SCALE_REFIT_SYMBOLS)
    devs = jax.devices()[:4]
    rng = np.random.default_rng(seed)
    carriers = np.arange(channels) % 64 == 0
    cfo = rng.uniform(-30, 30, channels).astype(np.float32)
    offs = rng.integers(0, cfg.packet_size, channels)
    with jax.default_device(devs[0]):
        pcm, _, _ = jax.jit(lambda k: synth_channels(
            cfg, k, channels, blocks, n_pkts=1,
            carriers=jnp.asarray(carriers),
            snr_db=jnp.full(channels, 12.0, jnp.float32),
            cfo_hz=jnp.asarray(cfo), offsets=jnp.asarray(offs)))(
                jax.random.PRNGKey(seed))

    single = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p))
    _, ref = single(jax.device_put(prod_rx_init_planes(cfg, channels),
                                   devs[0]), pcm)
    ref = _np(ref)
    samples = blocks * channels * cfg.frame_size

    def check(name, out):
        spans = all(len(x.sharding.device_set) == 4
                    for x in jax.tree.leaves(out))
        got = _np(out)
        same = (np.array_equal(got.valid, ref.valid)
                and np.array_equal(got.lag[ref.valid], ref.lag[ref.valid])
                and np.array_equal(got.timing_phase[ref.valid],
                                   ref.timing_phase[ref.valid])
                and np.array_equal(got.bits[ref.valid], ref.bits[ref.valid]))
        log(f"{name}: detections {int(got.valid.sum())} vs single-card "
            f"{int(ref.valid.sum())}, identical decisions: {same}, "
            f"valid differs on {int((got.valid != ref.valid).sum())} "
            f"blocks, outputs span 4 cards: {spans}")
        return same and spans

    mesh = make_mesh(ch=4, time=1, devices=devs)
    sharded = make_sharded_batch_rx(cfg, mesh)
    pcm_sh = jax.device_put(pcm, NamedSharding(mesh, P(None, "ch")))
    st = shard_plane_state(prod_rx_init_planes(cfg, channels), mesh)
    st, out = sharded(st, pcm_sh)
    ok = check("ch mesh 4", out)
    jax.block_until_ready(st)
    st = shard_plane_state(prod_rx_init_planes(cfg, channels), mesh)
    t0 = time.perf_counter()
    st, out = sharded(st, pcm_sh)
    jax.block_until_ready((st, out))
    wall = time.perf_counter() - t0
    log(f"ch mesh 4: {samples / wall / 4:.6e} samples/s per card "
        f"(wall {wall:.4f} s for {samples} samples)")

    mesh2 = make_mesh(ch=2, time=2, devices=devs)
    grid = make_grid_batch_rx(cfg, mesh2)
    pcm_g = jax.device_put(pcm, NamedSharding(mesh2, P("time", "ch")))
    out = grid(pcm_g)
    ok &= check("grid ch=2 x time=2", out)
    t0 = time.perf_counter()
    out = grid(pcm_g)
    jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    log(f"grid 2x2: {samples / wall / 4:.6e} samples/s per card "
        f"(wall {wall:.4f} s)")
    return ok


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4])
    args = ap.parse_args(argv)

    devs = require_gpu(args.cards)
    import jax

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    def log(msg):
        print(msg, flush=True)

    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    card = card_line()
    log(f"nvidia-smi: {card}")

    phases = ([("four_cards", phase_four_cards)] if args.cards == 4 else
              [("faithful_parity", phase_faithful),
               ("core_vs_oracle", phase_core_vs_oracle),
               ("scale", phase_scale),
               ("gated", phase_gated),
               ("file_fed", phase_file_fed),
               ("cli", phase_cli)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"--- phase {name}")
        try:
            ok = fn(lambda m, n=name: log(f"[{n}] {m}"))
        except Exception as e:              # report and go on
            import traceback
            traceback.print_exc()
            log(f"[{name}] raised {type(e).__name__}: {e}")
            ok = False
        log(f"--- phase {name}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            failed.append(name)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
