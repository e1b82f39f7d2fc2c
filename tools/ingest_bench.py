#!/usr/bin/env python
"""File-fed ingest measurement: file -> host assembly -> H2D -> core.

Builds an interleaved int16 PCM fixture file (sample-major, the ADC's
natural layout) inside the checkout, then measures each stage and the
overlapped end-to-end rate through the batch core (prod_rx_batch):

  * host_assembly:  mmap read + blocked native deinterleave into
                    [B, C, frame_size] dispatch buffers (GB/s), over
                    1/4/8/16 worker threads;
  * host_memcpy:    a plain copy of one dispatch buffer (the ceiling of
                    a memcpy-class pass);
  * ring_mode:      the FrameRing live-capture path at modest C;
  * h2d:            jax.device_put of one dispatch buffer (GB/s);
  * compute_only:   chained core dispatches on a resident operand;
  * end_to_end:     runtime/ingest.feed() -- producer-thread assembly,
                    double-buffered H2D, chained async dispatches.

Prints one JSON line naming the device.  Usage:
  python tools/ingest_bench.py [--channels 4096 --blocks 8]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# runnable as `python tools/ingest_bench.py` from the repo root
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=8,
                    help="time blocks per dispatch")
    ap.add_argument("--dispatches", type=int, default=8,
                    help="timed end-to-end dispatches")
    ap.add_argument("--file-dispatches", type=int, default=2,
                    help="dispatch-groups of PCM in the fixture file "
                         "(looped for longer runs)")
    ap.add_argument("--ring-channels", type=int, default=64,
                    help="channel count for the FrameRing datapoint")
    args = ap.parse_args()

    import numpy as np

    import jax

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from singlecarrier_tpu.config import DEFAULT_CONFIG
    from singlecarrier_tpu.modem import prod_rx_init_planes
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch
    from singlecarrier_tpu.runtime.ingest import (PcmDispatchSource,
                                              PrefetchIngest, feed)

    cfg = DEFAULT_CONFIG.replace(hunt_dtype="int8", ls_refit_symbols=128)
    C, B = args.channels, args.blocks
    n = cfg.frame_size
    disp_bytes = B * C * n * 2
    reps = max(2, args.dispatches // 2)
    dev = jax.devices()[0]
    report = {"platform": dev.platform, "device_kind": dev.device_kind,
              "channels": C, "blocks_per_dispatch": B,
              "dispatches": args.dispatches, "dispatch_bytes": disp_bytes}
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))

    with tempfile.TemporaryDirectory(dir=repo) as tmp:
        path = _os.path.join(tmp, "fixture.raw")
        rng = np.random.default_rng(0)
        with open(path, "wb") as f:
            for _ in range(args.file_dispatches * B):
                f.write(rng.integers(-16384, 16384, C * n,
                                     dtype=np.int16).tobytes())

        report["host_assembly_gbps"] = {}
        for w in (1, 4, 8, 16):
            src = PcmDispatchSource(path, C, n, B, loop=True, workers=w)
            buf = src.read_dispatch()                 # warm page cache
            t0 = time.perf_counter()
            for _ in range(reps):
                src.read_dispatch(out=buf)
            dt = time.perf_counter() - t0
            report["host_assembly_gbps"][str(w)] = reps * disp_bytes / dt / 1e9
            src.close()

        big = np.empty_like(buf)
        t0 = time.perf_counter()
        for _ in range(reps):
            np.copyto(big, buf)
        report["host_memcpy_gbps"] = (reps * disp_bytes
                                      / (time.perf_counter() - t0) / 1e9)

        rc = args.ring_channels
        rsrc = PcmDispatchSource(path, rc, n, B, loop=True, mode="ring")
        rbuf = rsrc.read_dispatch()
        t0 = time.perf_counter()
        for _ in range(reps):
            rsrc.read_dispatch(out=rbuf)
        report["ring_mode_channels"] = rc
        report["ring_mode_gbps"] = (reps * B * rc * n * 2
                                    / (time.perf_counter() - t0) / 1e9)
        rsrc.close()

        def demod(state, pcm):
            st, out = prod_rx_batch(cfg, state, pcm)
            return st, out.valid.sum()

        step = jax.jit(demod, donate_argnums=(0,))

        dev_buf = jax.device_put(buf)
        dev_buf.block_until_ready()
        t0 = time.perf_counter()
        jax.device_put(buf).block_until_ready()
        report["h2d_gbps"] = disp_bytes / (time.perf_counter() - t0) / 1e9

        state = prod_rx_init_planes(cfg, C)
        for _ in range(2):
            state, chk = step(state, dev_buf)
        jax.block_until_ready((state, chk))
        t0 = time.perf_counter()
        for _ in range(args.dispatches):
            state, chk = step(state, dev_buf)
        jax.block_until_ready((state, chk))
        report["compute_only_samples_per_sec"] = (
            args.dispatches * B * C * n / (time.perf_counter() - t0))

        src = PcmDispatchSource(path, C, n, B, loop=True, workers=8)
        try:
            ingest = PrefetchIngest(src, args.dispatches, depth=2)
            t0 = time.perf_counter()
            state, chk = feed(ingest, jax.device_put, step,
                              prod_rx_init_planes(cfg, C))
            jax.block_until_ready((state, chk))
            dt = time.perf_counter() - t0
        finally:
            src.close()
        report["end_to_end_samples_per_sec"] = (
            args.dispatches * B * C * n / dt)
        report["end_to_end_wall_s"] = dt

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    _sys.exit(main())
