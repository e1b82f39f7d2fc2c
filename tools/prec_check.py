#!/usr/bin/env python
"""BER of the production RX with float32 matmuls left at TF32 against
HIGHEST, on the same impaired streams.

Every product a decision depends on states its own precision; this
tool checks that nothing left unstated still moves the result.  It runs
``ber_run`` for each path (scan oracle, batch core) under
``jax.default_matmul_precision("tensorfloat32")`` and ``("highest")``
and prints one JSON line per run, naming the device.

  python tools/prec_check.py [--snr-db 8] [--trials 16]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# runnable as `python tools/prec_check.py` from the repo root
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr-db", type=float, default=8.0)
    ap.add_argument("--cfo-hz", type=float, default=15.0)
    ap.add_argument("--packets", type=int, default=10)
    ap.add_argument("--trials", type=int, default=16)
    args = ap.parse_args()

    import jax

    from singlecarrier_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from singlecarrier_tpu.ber import ber_run
    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg

    dev = jax.devices()[0]
    for path in ("xla", "batch"):
        for prec in ("tensorfloat32", "highest"):
            with jax.default_matmul_precision(prec):
                p = ber_run(cfg, jax.random.PRNGKey(9),
                            snr_db=args.snr_db, freq_hz=args.cfo_hz,
                            n_packets=args.packets, n_trials=args.trials,
                            path=path)
            print(json.dumps({"path": path, "default_precision": prec,
                              "device_kind": dev.device_kind,
                              "platform": dev.platform, **p}),
                  flush=True)
    return 0


if __name__ == "__main__":
    _sys.exit(main())
