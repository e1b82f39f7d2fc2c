#!/usr/bin/env python
"""Reduce a JAX profiler trace to where the device time goes.

    python tools/trace_top.py <trace_dir> [--top 20]

Reads the newest ``*.xplane.pb`` under ``<trace_dir>`` (the directory
given to ``jax.profiler.start_trace``) and prints, for each device
plane: the busy time (union of op intervals), the window, and the top
ops by summed device duration.  Given the compiled HLO text of the
traced program (``layers_from_hlo``), ops are also summed per layer:
the ``jax.named_scope`` stages of the batch core (frontend, hunt,
extract, decode) found in each HLO instruction's ``op_name``.  XLA
launches a program as one CUDA graph unless
``--xla_gpu_enable_command_buffer=`` is in ``XLA_FLAGS``; inside a graph
the trace names no HLO instruction, so every op lands in "other".
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re

LAYERS = ("frontend", "hunt", "extract", "decode")


def newest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def layers_from_hlo(hlo_text: str) -> dict:
    """HLO instruction name -> layer, from each instruction's op_name
    metadata (the first LAYERS scope on its path, else "other")."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            path = m.group(2).split("/")
            out[m.group(1)] = next((p for p in path if p in LAYERS),
                                   "other")
    return out


def _stat(event, name):
    for k, v in event.stats:
        if k == name:
            return str(v)
    return ""


def device_summary(path: str, top: int = 20, layers: dict | None = None):
    """[(plane, busy_ns, window_ns, top rows, per-layer ns)]; a row is
    (op, layer, total_ns, count)."""
    from jax.profiler import ProfileData

    layers = layers or {}
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        ops = collections.defaultdict(lambda: [0, 0, "other"])
        per_layer = collections.Counter()
        spans = []
        lines = [l for l in plane.lines if l.name == "XLA Ops"] or [
            l for l in plane.lines
            if "Module" not in l.name and "Step" not in l.name]
        for line in lines:
            for e in line.events:
                layer = layers.get(_stat(e, "hlo_op"), "other")
                rec = ops[e.name]
                rec[0] += e.duration_ns
                rec[1] += 1
                rec[2] = layer
                per_layer[layer] += e.duration_ns
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
        if not spans:
            continue
        spans.sort()
        busy, end = 0, None
        for s, t in spans:
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        window = max(t for _, t in spans) - spans[0][0]
        rows = sorted(((n, r[2], r[0], r[1]) for n, r in ops.items()),
                      key=lambda r: -r[2])[:top]
        out.append((plane.name, busy, window, rows, dict(per_layer)))
    return out


def print_summary(summary) -> None:
    for plane, busy, window, rows, per_layer in summary:
        print(f"{plane}: busy {busy / 1e6:.3f} ms of a "
              f"{window / 1e6:.3f} ms window")
        for layer, ns in sorted(per_layer.items(), key=lambda x: -x[1]):
            print(f"  layer {layer:9s} {ns / 1e6:10.3f} ms")
        for name, layer, ns, count in rows:
            print(f"  {ns / 1e6:10.3f} ms  x{count:<5d} {layer:9s} "
                  f"{name[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--hlo", default=None,
                    help="compiled HLO text of the traced program")
    args = ap.parse_args()
    layers = None
    if args.hlo:
        with open(args.hlo) as f:
            layers = layers_from_hlo(f.read())
    print_summary(device_summary(newest_xplane(args.trace_dir), args.top,
                                 layers))


if __name__ == "__main__":
    main()
