"""Native IO engine tests (native/scio.cc via ctypes)."""

import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from singlecarrier_tpu.runtime import engine


def test_deinterleave_roundtrip():
    rng = np.random.default_rng(0)
    chans = rng.integers(-32768, 32767, (16, 1000), dtype=np.int16)
    inter = engine.interleave(chans)
    assert inter.shape == (16000,)
    # interleaved layout: sample-major
    assert inter[0] == chans[0, 0]
    assert inter[1] == chans[1, 0]
    back = engine.deinterleave(inter, 16)
    assert np.array_equal(back, chans)


def test_frame_ring():
    rng = np.random.default_rng(1)
    n_ch, fs = 4, 100
    ring = engine.FrameRing(n_ch, fs, capacity_blocks=4)
    chans = rng.integers(-100, 100, (n_ch, 250), dtype=np.int16)
    inter = engine.interleave(chans).reshape(250, n_ch)

    # push in odd-sized chunks
    assert ring.push(inter[:77]) == 77
    assert ring.blocks_ready == 0
    assert ring.push(inter[77:160]) == 83
    assert ring.blocks_ready == 1
    assert ring.push(inter[160:]) == 90
    assert ring.blocks_ready == 2

    b0 = ring.pop()
    b1 = ring.pop()
    assert ring.pop() is None
    assert np.array_equal(b0, chans[:, :100])
    assert np.array_equal(b1, chans[:, 100:200])
    ring.close()


def test_ring_backpressure():
    ring = engine.FrameRing(2, 10, capacity_blocks=2)
    data = np.zeros((100, 2), np.int16)
    consumed = ring.push(data)
    # capacity 2 blocks of 10 samples + 10 staged in the write block...
    # ring refuses once full: 2 blocks * 10
    assert consumed == 20
    assert ring.blocks_ready == 2
    ring.pop()
    assert ring.push(data[consumed:]) == 10
    ring.close()


def test_pcm_file(tmp_path):
    p = str(tmp_path / "x.raw")
    data = np.arange(-500, 500, dtype=np.int16)
    data.tofile(p)
    f = engine.PcmFile(p)
    assert f.n_samples == 1000
    assert np.array_equal(f.read(0, 10), data[:10])
    assert np.array_equal(f.read(990, 20)[:10], data[990:])
    assert np.all(f.read(990, 20)[10:] == 0)  # zero-padded past EOF
    f.close()


def test_golden_vector_via_engine(golden, tmp_path):
    """The frozen fixture stream (tests/golden/reference.npz tx_pcm,
    10 packets) written as raw int16 reads back whole through the
    engine."""
    p = str(tmp_path / "golden.raw")
    golden["tx_pcm"].astype("<i2").tofile(p)
    f = engine.PcmFile(p)
    assert f.n_samples == 27830
    assert np.array_equal(f.read(0, f.n_samples), golden["tx_pcm"])
    f.close()


def test_ingest_pipeline_decodes(tmp_path):
    """runtime/ingest: file -> producer-thread assembly -> feed() ->
    batch core decodes a real packet stream end-to-end, both assembly
    modes agreeing."""
    import jax
    import jax.numpy as jnp

    from singlecarrier_tpu.config import DEFAULT_CONFIG as cfg
    from singlecarrier_tpu.modem import prod_rx_init_planes, tx_stream
    from singlecarrier_tpu.modem.rx_production import prod_rx_batch
    from singlecarrier_tpu.runtime.ingest import (PcmDispatchSource,
                                                  PrefetchIngest, feed)

    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, (3, cfg.ns, cfg.data_symbols * 2),
                        dtype=np.uint8)
    pcm = np.asarray(tx_stream(cfg, jnp.asarray(bits),
                               flush_gap=True))
    C, B = 2, 4
    n_disp = 2
    total = n_disp * B * cfg.frame_size
    stream = np.zeros(total, np.int16)
    stream[:len(pcm)] = pcm
    # interleaved file: every channel carries the same stream
    inter = np.repeat(stream, C).astype(np.int16)
    path = str(tmp_path / "ingest.raw")
    inter.tofile(path)

    outs = []
    rx = jax.jit(lambda st, p: prod_rx_batch(cfg, st, p,
                                             descramble=False))

    def run(mode):
        src = PcmDispatchSource(path, C, cfg.frame_size, B, mode=mode)
        ingest = PrefetchIngest(src, n_disp, depth=1)
        state = prod_rx_init_planes(cfg, C)
        collected = []

        def step(st, dev):
            st, out = rx(st, dev)
            collected.append(jax.tree.map(np.asarray, out))
            return st, out.valid.sum().astype(jnp.float32)

        # step stays un-jitted: it appends host copies per dispatch
        put = lambda b: jnp.asarray(b)  # noqa: E731
        _, chk = feed(ingest, put, step, state)
        src.close()
        v = np.concatenate([o.valid for o in collected], 0)
        bts = np.concatenate([o.bits for o in collected], 0)
        return v, bts

    for mode in ("deinterleave", "ring"):
        v, bts = run(mode)
        assert v.sum() == 3 * C, mode
        for c in range(C):
            got = bts[:, c][v[:, c]]
            assert np.array_equal(
                got, bits.reshape(3, cfg.bits_per_frame)), mode
        outs.append((v, bts))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
