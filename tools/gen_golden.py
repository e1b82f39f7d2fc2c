#!/usr/bin/env python
"""Build the patched C reference + harness and emit golden fixtures.

Reads the reference sources from /root/reference (read-only), applies the
minimal deviations documented in SURVEY.md ("known defects" 1): the
decimated_frame buffer is sized 752 as intended instead of the
out-of-bounds 562 (src/qpsk.c:42), since parity is defined against
intended behavior, not undefined behavior.  Everything else (including
the rx_timing clobber at qpsk.c:219) is kept verbatim.

The harness (tools/harness/golden_main.c) is appended to the patched
qpsk.c translation unit so it can reach the static modem state.  Output
trajectories are parsed into tests/golden/reference.npz.

Usage: python tools/gen_golden.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

# runnable as `python tools/gen_golden.py` from the repo root
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = pathlib.Path("/root/reference")
BUILD = REPO / ".golden_build"
OUT = REPO / "tests" / "golden" / "reference.npz"

PROLOGUE = """
/* golden-harness instrumentation globals */
int golden_last_matches, golden_last_max_index;
float golden_last_max_value, golden_last_mean;
"""


def patch_qpsk(src: str, foffset: float = 0.0) -> str:
    # Fix the OOB buffer (SURVEY.md quirk #1): intended size is
    # 2 * FRAME_SIZE / CYCLES = 752.
    assert "decimated_frame[562]" in src
    src = src.replace("decimated_frame[562]", "decimated_frame[752]")
    # Drop DEBUG2 printfs; the harness does its own structured dumps.
    src = src.replace("#define DEBUG2\n", "")
    # Record hunt statistics for the dump.
    anchor = "    float mean = magnitude(decimated_frame, max_index);\n"
    assert anchor in src
    src = src.replace(
        anchor,
        anchor
        + "    golden_last_matches = matches;\n"
        + "    golden_last_max_index = max_index;\n"
        + "    golden_last_max_value = max_value;\n"
        + "    golden_last_mean = mean;\n",
    )
    # Rename main so the harness provides its own.
    assert "int main(int argc, char** argv)" in src
    src = src.replace("int main(int argc, char** argv)",
                      "static int reference_main_unused(int argc, char** argv)")
    # RX carrier-offset knob (the reference's compile-time FOFFSET,
    # qpsk.c:67) -- a second build exercises faithful-mode offset parity.
    assert "#define FOFFSET 0.0f" in src
    src = src.replace("#define FOFFSET 0.0f",
                      f"#define FOFFSET {foffset}f")
    return PROLOGUE + src


def build(foffset: float = 0.0, tag: str = "") -> pathlib.Path:
    BUILD.mkdir(exist_ok=True)
    qpsk = patch_qpsk((REF / "src/qpsk.c").read_text(), foffset)
    harness = (REPO / "tools/harness/golden_main.c").read_text()
    (BUILD / f"golden_qpsk{tag}.c").write_text(
        qpsk
        + "\nextern complex float eq_coeff[];\n"
        + harness
    )
    exe = BUILD / f"golden{tag}"
    cmd = [
        "gcc", "-O2", "-std=c99", "-I", str(REF / "headers"),
        str(BUILD / f"golden_qpsk{tag}.c"),
        str(REF / "src/constants.c"),
        str(REF / "src/fir.c"),
        str(REF / "src/kalman.c"),
        str(REF / "src/equalizer.c"),
        str(REF / "src/scramble.c"),
        str(REF / "src/fft.c"),
        "-lm", "-o", str(exe),
        "-Wno-unused-function",
    ]
    subprocess.run(cmd, check=True)
    return exe


def parse(text: str) -> dict:
    data: dict = {}
    rx: dict[str, dict] = {"RXG": {}, "RXT": {}}
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "FIR_IN" or tag == "FIR_OUT":
            n = int(parts[1])
            v = np.array(parts[2:], dtype=np.float64)
            data[tag.lower()] = (v[0::2] + 1j * v[1::2]).astype(np.complex64)
            assert len(data[tag.lower()]) == n
        elif tag == "EQ_IN":
            v = np.array(parts[2:], dtype=np.float64)
            data["eq_in"] = (v[0::2] + 1j * v[1::2]).astype(np.complex64)
        elif tag == "EQ_TRAIN":
            data["eq_train_err"] = np.array(parts[2:], dtype=np.float32)
        elif tag in ("EQ_COEFF_AFTER_TRAIN", "EQ_COEFF_AFTER_DATA"):
            v = np.array(parts[2:], dtype=np.float64)
            data[tag.lower()] = (v[0::2] + 1j * v[1::2]).astype(np.complex64)
        elif tag == "EQ_DATA":
            v = parts[2:]
            data["eq_data_dibits"] = np.array(v[0::2], dtype=np.uint8)
            data["eq_data_err"] = np.array(v[1::2], dtype=np.float32)
        elif tag == "SCRAMBLE_ZERO":
            data["scramble_zero_dibits"] = np.array(parts[2:], dtype=np.uint8)
        elif tag == "TX_BITS":
            data["tx_bits"] = np.frombuffer(
                parts[2].encode(), dtype=np.uint8) - ord("0")
        elif tag == "TX_PCM":
            data["tx_pcm"] = np.array(parts[2:], dtype=np.int16)
        elif tag.endswith("_NFRAMES"):
            rx[tag[:3]]["nframes"] = int(parts[1])
        elif tag.endswith("_FRAME"):
            d = rx[tag[:3]].setdefault("frames", [])
            # <fr> valid <v> rx_timing <t> matches <m> max_index <mi>
            # max_value <mv> mean <me>
            kv = dict(zip(parts[2::2], parts[3::2]))
            d.append((int(parts[1]), int(kv["valid"]), int(kv["rx_timing"]),
                      int(kv["matches"]), int(kv["max_index"]),
                      float(kv["max_value"]), float(kv["mean"])))
        elif tag.endswith("_BITS"):
            d = rx[tag[:3]].setdefault("bits", [])
            d.append(np.frombuffer(parts[2].encode(), dtype=np.uint8)
                     - ord("0"))
    for name, d in rx.items():
        fr = np.array(d["frames"], dtype=np.float64)
        data[f"{name.lower()}_valid"] = fr[:, 1].astype(np.int32)
        data[f"{name.lower()}_rx_timing"] = fr[:, 2].astype(np.int32)
        data[f"{name.lower()}_matches"] = fr[:, 3].astype(np.int32)
        data[f"{name.lower()}_max_index"] = fr[:, 4].astype(np.int32)
        data[f"{name.lower()}_max_value"] = fr[:, 5].astype(np.float32)
        data[f"{name.lower()}_mean"] = fr[:, 6].astype(np.float32)
        data[f"{name.lower()}_bits"] = np.stack(d["bits"])
    return data


def main() -> None:
    exe = build()
    res = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True)
    data = parse(res.stdout)

    # Second build with a 20 Hz RX carrier offset: faithful-mode
    # frequency-offset parity fixtures (keys prefixed f20_).
    exe20 = build(foffset=20.0, tag="_f20")
    res20 = subprocess.run([str(exe20)], capture_output=True, text=True,
                           check=True)
    data20 = parse(res20.stdout)
    for k in list(data20.keys()):
        if k.startswith("rxg_") or k.startswith("rxt_"):
            data[f"f20_{k}"] = data20[k]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT} with keys: {sorted(data.keys())}")
    for k, v in sorted(data.items()):
        print(f"  {k}: {getattr(v, 'shape', v)} {getattr(v, 'dtype', '')}")


if __name__ == "__main__":
    sys.exit(main())
