"""tools/trace_top.py: HLO instructions of the batch core map to its
named-scope layers."""

import collections
import os
import sys

import jax
import jax.numpy as jnp

from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem.rx_production import (prod_rx_batch,
                                               prod_rx_init_planes)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from trace_top import LAYERS, layers_from_hlo  # noqa: E402


def test_core_hlo_maps_to_every_layer():
    comp = jax.jit(lambda s, p: prod_rx_batch(CFG, s, p)).lower(
        prod_rx_init_planes(CFG, 2),
        jnp.zeros((2, 2, CFG.frame_size), jnp.int16)).compile()
    layers = collections.Counter(layers_from_hlo(comp.as_text()).values())
    for layer in LAYERS:
        assert layers[layer] > 0, (layer, layers)
