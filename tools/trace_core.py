#!/usr/bin/env python
"""Where the device time of one batch-core dispatch goes.

    python tools/trace_core.py [--channels 262144] [--blocks 4]
                               [--hunt-dtype int8]

Runs ``prod_rx_batch`` on on-device noise (the decode work is masked
dataflow, so noise costs what packets cost), prints the step time of
five chained dispatches, ``memory_analysis()`` and the peak device
memory, then traces one dispatch and prints the busy time, the device
time per layer (frontend, hunt, extract, decode) and the top ops
(tools/trace_top.py).  XLA's CUDA-graph launch is switched off for this
process so the trace names each op's HLO instruction; times are with
that setting.
"""

from __future__ import annotations

import os as _os
import sys as _sys

# per-op HLO names in the trace (set before JAX starts)
_os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                            + " --xla_gpu_enable_command_buffer=")
_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path.insert(0, _os.path.dirname(_HERE))
_sys.path.insert(0, _HERE)

import argparse
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=262144)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--hunt-dtype", default="int8",
                    choices=["bf16", "f32", "int8"])
    ap.add_argument("--refit-symbols", type=int, default=128)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG
    from singlecarrier_tpu.modem.rx_production import (prod_rx_batch,
                                                   prod_rx_init_planes)
    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    from trace_top import (device_summary, layers_from_hlo,
                           newest_xplane, print_summary)

    enable_compilation_cache()
    cfg = DEFAULT_CONFIG.replace(hunt_dtype=args.hunt_dtype,
                                 ls_refit_symbols=args.refit_symbols)
    C, B, n = args.channels, args.blocks, cfg.frame_size
    step = jax.jit(lambda s, p: prod_rx_batch(cfg, s, p),
                   donate_argnums=(0,))

    @jax.jit
    def synth(key):
        def one(k):
            return (jax.random.normal(k, (C, n)) * 3000).astype(jnp.int16)
        return jax.lax.map(one, jax.random.split(key, B))

    pcm = synth(jax.random.PRNGKey(1))
    st = prod_rx_init_planes(cfg, C)
    comp = step.lower(st, pcm).compile()
    print(f"memory_analysis: {comp.memory_analysis()}", flush=True)
    st, out = comp(st, pcm)
    jax.block_until_ready(out)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        st, out = comp(st, pcm)
        jax.block_until_ready((st, out))
        times.append(time.perf_counter() - t0)
    dev = jax.devices()[0]
    print(f"{dev.platform} {dev.device_kind}: {C} ch x {B} blocks, "
          f"hunt {cfg.hunt_dtype}; step s {times}; samples/s "
          f"{[C * B * n / t for t in times]}", flush=True)
    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)

    tdir = _os.path.join(_os.path.dirname(_HERE), "traces", "core")
    jax.profiler.start_trace(tdir)
    st, out = comp(st, pcm)
    jax.block_until_ready((st, out))
    jax.profiler.stop_trace()
    print_summary(device_summary(newest_xplane(tdir), args.top,
                                 layers_from_hlo(comp.as_text())))
    return 0


if __name__ == "__main__":
    _sys.exit(main())
