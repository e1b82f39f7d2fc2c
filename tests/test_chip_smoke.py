"""chip_smoke.py: its device guard, and every phase at a tiny size on
the CPU (the card runs them at full width)."""

import shutil

import jax
import pytest

import chip_smoke


def test_chip_smoke_refuses_cpu(capsys):
    """No GPU -> exit non-zero before any phase, no result line."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def _run(phase, **kw):
    lines = []
    ok = phase(lines.append, **kw)
    assert ok, "\n".join(lines)


def test_smoke_phase_faithful_parity():
    _run(chip_smoke.phase_faithful)


def test_smoke_phase_core_vs_oracle():
    _run(chip_smoke.phase_core_vs_oracle, channels=16, blocks=8)


def test_smoke_phase_scale():
    _run(chip_smoke.phase_scale, channels=256, blocks=4, every=64,
         sampled=8)


def test_smoke_phase_gated():
    _run(chip_smoke.phase_gated, channels=48, blocks=12, dispatch=4,
         every=8)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_smoke_phase_file_fed():
    _run(chip_smoke.phase_file_fed, channels=16, blocks=4, dispatches=2)


def test_smoke_phase_cli():
    _run(chip_smoke.phase_cli, packets=3)


def test_smoke_phase_four_cards():
    """The --cards 4 phase on four of the virtual CPU devices."""
    assert len(jax.devices()) >= 4
    _run(chip_smoke.phase_four_cards, channels=128, blocks=4)
