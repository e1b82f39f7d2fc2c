"""Checkpoint / resume of demodulator state.

The reference has no persistence at all -- its state dies with the
process (static globals, SURVEY.md section 5).  Here the per-channel
state is an explicit pytree, so checkpointing between streaming blocks
is exact by construction: save the pytree, restore it, continue --
bit-identical resume (tested in tests/test_runtime.py,
tests/test_checkpoint_sharded.py).

Two paths:

 * ``save_state`` / ``restore_state`` -- single-file pickle of the
   fetched-to-host tree.  Right for small channel counts and for
   states that must travel as one portable artifact.
 * ``save_sharded`` / ``restore_sharded`` -- one ``.npy`` file per
   addressable shard of each leaf, plus a per-process JSON index of
   which region of the global array each file holds.  Every process
   writes only its own shards, and restore builds each target shard
   from the files that overlap it, on the device that owns it, without
   the state ever being gathered to one host.  This is the path for
   1M-channel sharded state across several cards or hosts.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def save_state(path: str, state: Any, *, step: int = 0) -> None:
    """Persist a demod state pytree (+ stream position) to one file.

    Fetches everything to this host -- use ``save_sharded`` for state
    sharded across devices/hosts at scale.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"step": step, "state": jax.tree.map(np.asarray, state)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def restore_state(path: str, like: Any = None):
    """Load ``(state, step)``; ``like`` supplies the pytree structure
    check (optional)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    state = jax.tree.map(jnp.asarray, payload["state"])
    if like is not None:
        ts, tl = jax.tree.structure(state), jax.tree.structure(like)
        if ts != tl:
            raise ValueError(f"checkpoint structure {ts} != expected {tl}")
    return state, payload["step"]


# ---------------------------------------------------------------------------
# Sharded path: per-shard numpy files


def _region(index, shape):
    """A shard index (tuple of slices) as [[start, stop], ...]."""
    out = []
    for sl, n in zip(index, shape):
        start, stop, _ = sl.indices(n)
        out.append([start, stop])
    return out


def save_sharded(path: str, state: Any, *, step: int = 0) -> None:
    """Save a (possibly multi-host-sharded) state pytree as per-shard
    ``.npy`` files under the directory ``path``.

    Each process writes the shards it holds (one replica of each) and
    an index ``shards.<process>.json``; process 0 writes ``meta.json``.
    Safe to call from every process of a multi-host run with the same
    ``path``.
    """
    import json

    proc = jax.process_index()
    os.makedirs(path, exist_ok=True)
    entries = []
    for i, leaf in enumerate(jax.tree.leaves(state)):
        leaf = jnp.asarray(leaf)
        for shard in leaf.addressable_shards:
            if shard.replica_id != 0:
                continue
            region = _region(shard.index, leaf.shape)
            name = f"leaf{i}." + "_".join(
                f"{a}-{b}" for a, b in region) + ".npy"
            np.save(os.path.join(path, name), np.asarray(shard.data))
            entries.append({"leaf": i, "file": name, "region": region})
    with open(os.path.join(path, f"shards.{proc}.json"), "w") as f:
        json.dump(entries, f)
    if proc == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": int(step)}, f)


def restore_sharded(path: str, like: Any):
    """Restore ``(state, step)`` saved by ``save_sharded``.

    ``like``: a state pytree (concrete or ShapeDtypeStruct) whose
    shapes/dtypes/shardings describe the restore targets -- each
    target shard is assembled from the saved files that overlap it and
    placed on the device that owns it.
    """
    import glob
    import json

    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    pieces: dict[int, list] = {}
    for idx_file in glob.glob(os.path.join(path, "shards.*.json")):
        with open(idx_file) as f:
            for e in json.load(f):
                pieces.setdefault(e["leaf"], []).append(e)

    def restore_leaf(i, x):
        shape, dtype = tuple(x.shape), np.dtype(x.dtype)

        def region_data(index):
            want = _region(index, shape)
            out = np.empty([b - a for a, b in want], dtype)
            for e in pieces.get(i, []):
                lo = [max(a, c) for (a, _), (c, _) in zip(want, e["region"])]
                hi = [min(b, d) for (_, b), (_, d) in zip(want, e["region"])]
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                data = np.load(os.path.join(path, e["file"]),
                               mmap_mode="r")
                src = tuple(slice(l - c, h - c) for l, h, (c, _)
                            in zip(lo, hi, e["region"]))
                dst = tuple(slice(l - a, h - a) for l, h, (a, _)
                            in zip(lo, hi, want))
                out[dst] = data[src]
            return out

        sharding = getattr(x, "sharding", None)
        if sharding is None:
            return jnp.asarray(
                region_data(tuple(slice(None) for _ in shape)))
        return jax.make_array_from_callback(shape, sharding, region_data)

    leaves, treedef = jax.tree.flatten(like)
    state = jax.tree.unflatten(
        treedef, [restore_leaf(i, x) for i, x in enumerate(leaves)])
    return state, step
