#!/usr/bin/env python
"""Scaling of the sharded batch core over 1/2/4 devices.

The SAME TOTAL WORK runs unpartitioned and partitioned over an
N-device mesh:

  * DP (channel-sharded): make_sharded_batch_rx over a [ch] mesh;
  * 2D grid (ch x time): make_grid_batch_rx over (ch=N/2, time=2),
    halos riding ppermute on the time axis.

On separate cards the speedup column is the scaling efficiency.  On
virtual CPU devices (``--platform cpu``), which share one host's cores,
only the overhead of partitioning is meaningful.  Prints markdown
tables and one JSON line naming the device.

Usage:
  python tools/scaling_bench.py [--channels 65536 --blocks 4]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# runnable as `python tools/scaling_bench.py` from the repo root
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import json
import os
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=65536,
                    help="TOTAL channels (fixed across device counts)")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--vdevices", type=int, default=8,
                    help="virtual CPU device count (with --platform cpu)")
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.vdevices}")

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem.rx_production import prod_rx_init_planes
    from singlecarrier_tpu.parallel import (make_grid_batch_rx,
                                        make_sharded_batch_rx,
                                        shard_plane_state)

    devs = jax.devices()
    C, B = args.channels, args.blocks
    rng = np.random.default_rng(0)
    pcm_np = rng.integers(
        -16384, 16384, (B, C, cfg.frame_size)).astype(np.int16)

    def timeit(fn, *a):
        for _ in range(args.warmup):
            out = fn(*a)
            jax.block_until_ready(jax.tree.leaves(out)[0])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(*a)
            jax.block_until_ready(jax.tree.leaves(out)[0])
        return (time.perf_counter() - t0) / args.iters

    # ---- DP: same total channels, partitioned 1/2/4/8 ways ----
    counts = [d for d in (1, 2, 4, 8) if d <= len(devs) and C % d == 0]
    dp_rows = []
    base_dt = None
    for nd in counts:
        mesh = Mesh(np.array(devs[:nd]), ("ch",))
        fn = make_sharded_batch_rx(cfg, mesh)
        pcm = jax.device_put(
            jnp.asarray(pcm_np), NamedSharding(mesh, P(None, "ch")))
        dt = timeit(lambda p: fn(shard_plane_state(
            prod_rx_init_planes(cfg, C), mesh), p)[1], pcm)
        if base_dt is None:
            base_dt = dt
        dp_rows.append({
            "devices": nd, "channels": C, "wall_s": dt,
            "samples_per_sec": C * B * cfg.frame_size / dt,
            "speedup": base_dt / dt,
        })

    # ---- 2D grid: (ch = N/2, time = 2), same total work ----
    grid_rows = []
    for nd in counts:
        if nd < 2 or B % 2 != 0 or B < 4 or C % (nd // 2) != 0:
            continue
        mesh = Mesh(np.array(devs[:nd]).reshape(nd // 2, 2),
                    ("ch", "time"))
        fn = make_grid_batch_rx(cfg, mesh)
        pcm = jax.device_put(
            jnp.asarray(pcm_np), NamedSharding(mesh, P("time", "ch")))
        dt = timeit(fn, pcm)
        grid_rows.append({
            "devices": nd, "grid": f"{nd // 2}x2",
            "channels": C, "wall_s": dt,
            "samples_per_sec": C * B * cfg.frame_size / dt,
            "speedup": base_dt / dt,
        })

    def table(rows, grid=False):
        hdr = ("| devices | grid (ch x time) |" if grid else "| devices |")
        lines = [hdr + " channels | samples/s | speedup vs 1 device |",
                 "|---|---|---|---|" + ("---|" if grid else "")]
        for r in rows:
            g = f" {r['grid']} |" if grid else ""
            lines.append(
                f"| {r['devices']} |{g} {r['channels']} | "
                f"{r['samples_per_sec']:.4e} | {r['speedup']:.3f} |")
        return "\n".join(lines)

    dp_tbl = table(dp_rows)
    grid_tbl = table(grid_rows, grid=True)
    print(dp_tbl)
    print()
    print(grid_tbl)
    print(json.dumps({"metric": "sharded_scaling",
                      "dp_rows": dp_rows, "grid_rows": grid_rows,
                      "platform": devs[0].platform,
                      "device_kind": devs[0].device_kind}))


if __name__ == "__main__":
    main()
