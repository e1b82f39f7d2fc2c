"""Real multi-process multihost test.

Launches N=2 OS processes, each with 2 virtual CPU devices, wired
together with ``jax.distributed.initialize`` (parallel/multihost.py):
a 4-device global mesh spanning 2 "hosts".  Each host feeds its own
channel shard of a real modulated stream and verifies the decoded bits
of its local shards -- the pod launch path executed for real, not
dry-run.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_decode(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env_base["PYTHONPATH"] = repo + os.pathsep + env_base.get("PYTHONPATH", "")
    # per-process on-disk compile cache (no sharing needed; just speed)
    env_base["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")

    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m",
               "singlecarrier_tpu.parallel.multihost",
               f"--coordinator=127.0.0.1:{port}",
               "--num-processes=2", f"--process-id={pid}",
               "--packets=2", "--channels=4", "--platform=cpu"]
        procs.append(subprocess.Popen(
            cmd, env=env_base, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    joined = "\n==== proc boundary ====\n".join(o[-2000:] for o in outs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, joined
        assert "VERIFIED" in out, joined


def test_local_processes_pin_one_card_each(monkeypatch):
    """Processes coordinated on this host each own one card (a second
    JAX process on a held card fails); a remote coordinator leaves the
    choice to the caller."""
    import jax

    from singlecarrier_tpu.parallel import multihost

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    multihost.initialize("localhost:1234", 4, 2)
    multihost.initialize("127.0.0.1:1234", 4, 3)
    multihost.initialize("10.0.0.1:1234", 4, 1)
    multihost.initialize("10.0.0.1:1234", 4, 1, local_device_ids=[0, 1])
    assert [c["local_device_ids"] for c in calls] == [[2], [3], None,
                                                      [0, 1]]
    multihost.initialize(None)                # single process: no-op
    assert len(calls) == 4
