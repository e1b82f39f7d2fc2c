from .fir import fir_block, fir_init_state, banded_fir_matrix
from .mixer import mixer_table, mix_block, mixer_init_phase
from .decimate import decimate, decimate_at
from .correlate import preamble_corr_matrix, preamble_correlate, window_energy
from .frontend import frontend_planes, frontend_reference

__all__ = [
    "fir_block",
    "fir_init_state",
    "banded_fir_matrix",
    "mixer_table",
    "mix_block",
    "mixer_init_phase",
    "decimate",
    "decimate_at",
    "preamble_corr_matrix",
    "preamble_correlate",
    "window_energy",
    "frontend_planes",
    "frontend_reference",
]
