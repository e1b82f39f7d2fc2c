"""Multi-host (pod-slice) runner utilities.

The reference is a single process (SURVEY.md: zero distributed code);
scaling past one host uses JAX's multi-controller runtime: every host
runs the same program, ``jax.distributed.initialize`` wires the
coordination service, and the global mesh spans all hosts' devices.
XLA is the communication backend (NCCL between GPUs); there is no
hand-written collective to port.

Typical launch (one command per host):

  python -m singlecarrier_tpu.parallel.multihost \
      --coordinator=10.0.0.1:8476 --num-processes=4 --process-id=$ID

Several processes on ONE host must each own one card: a JAX process
reserves most of every card it opens, so a second process on a held
card fails.  ``initialize`` pins process ``i`` to local card ``i``
when the coordinator is on this host (``localhost``/``127.0.0.1``), or
to the cards ``local_device_ids`` names.

Host-local data feeding: each host owns the channels whose shards live
on its devices (``host_local_channels``); ``jax.make_array_from_
process_local_data`` assembles the global sharded array.
"""

from __future__ import annotations

import argparse

import numpy as np


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None) -> None:
    """Wire up the multi-controller runtime (no-op single-process)."""
    import jax
    if coordinator is None:
        return
    host = coordinator.rsplit(":", 1)[0]
    if local_device_ids is None and host in ("localhost", "127.0.0.1"):
        local_device_ids = [process_id]
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(time: int = 1):
    """[ch x time] mesh over ALL processes' devices."""
    from .mesh import make_mesh
    import jax
    return make_mesh(time=time, devices=jax.devices())


def host_local_channels(n_channels_global: int) -> slice:
    """The contiguous channel range this host feeds (channel-major
    layout over processes)."""
    import jax
    per = n_channels_global // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)


def make_global_pcm(mesh, pcm_local: np.ndarray):
    """Assemble the globally-sharded [channels, ...] PCM array from each
    host's local channel block."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = P("ch", *([None] * (pcm_local.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), pcm_local)


def main() -> int:
    """Multi-process end-to-end check: every host feeds its local
    channel block of a REAL modulated packet stream into the globally
    sharded RX, then verifies the decoded payload bits of its own
    shards against the (deterministically shared) sent bits.

    Exit code 0 = every local channel decoded every packet error-free.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None,
                    help="global channel count (default: 1 per device)")
    ap.add_argument("--packets", type=int, default=3)
    ap.add_argument("--local-device-ids", default=None,
                    help="comma-separated local cards this process "
                         "owns (default: its process id when the "
                         "coordinator is on localhost, else all)")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    local = (None if args.local_device_ids is None else
             [int(i) for i in args.local_device_ids.split(",")])
    initialize(args.coordinator, args.num_processes, args.process_id,
               local)
    import jax.numpy as jnp

    from ..config import DEFAULT_CONFIG as cfg
    from ..modem.rx_production import prod_rx_init
    from ..modem.tx import tx_stream
    from .sharded_rx import make_channel_sharded_rx, shard_channel_state

    n_channels = args.channels or len(jax.devices())
    mesh = global_mesh()
    fn = make_channel_sharded_rx(cfg, mesh, descramble=False)

    # Deterministic payload, identical on every host (seed is shared).
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, (args.packets, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    stream = np.asarray(tx_stream(cfg, jnp.asarray(bits), flush_gap=True))
    n_blocks = -(-len(stream) // cfg.frame_size)
    buf = np.zeros(n_blocks * cfg.frame_size, np.int16)
    buf[:len(stream)] = stream
    blocks = buf.reshape(n_blocks, cfg.frame_size)

    sl = host_local_channels(n_channels)
    local = np.broadcast_to(
        blocks[None], (sl.stop - sl.start, n_blocks, cfg.frame_size)
    ).copy()
    pcm = make_global_pcm(mesh, local)
    state = shard_channel_state(prod_rx_init(cfg, (n_channels,)), mesh)
    state, out = fn(state, pcm)
    jax.block_until_ready(out.valid)

    # Verify THIS host's shards: each local channel must decode every
    # packet bit-exactly (clean loopback channel).
    ref = bits.reshape(args.packets, cfg.bits_per_frame)
    ok = True
    n_local_ch = 0
    for vs, bs in zip(out.valid.addressable_shards,
                      out.bits.addressable_shards):
        v = np.asarray(vs.data)
        b = np.asarray(bs.data)
        for c in range(v.shape[0]):
            n_local_ch += 1
            vidx = np.nonzero(v[c])[0]
            if len(vidx) != args.packets:
                ok = False
                continue
            for i, fr in enumerate(vidx):
                if not np.array_equal(b[c, fr], ref[i]):
                    ok = False

    print(f"[host {jax.process_index()}/{jax.process_count()}] "
          f"{'VERIFIED' if ok else 'MISMATCH'}: {n_local_ch} local "
          f"channels x {args.packets} packets over {len(jax.devices())} "
          f"devices ({jax.local_device_count()} local)", flush=True)
    if jax.process_count() > 1:
        # Re-align before exit: host-side verification time is skewed
        # across processes, and the coordination service's shutdown
        # barrier times out if one process exits much later.
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("verify_done")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
