"""Shape/dtype assertion layer + device-side float checks.

The reference has no sanitizers and carries a real out-of-bounds write
(``decimated_frame[562]`` written at indices up to 751,
reference: src/qpsk.c:42 vs 157-162) that ASan would have caught
(SURVEY.md quirk #1).  The functional design removes whole classes of
such faults (no globals, no in-place aliasing), and this module covers
what remains:

 * ``assert_rx_state`` / ``assert_pcm_block`` -- host-side structural
   validation (chex) of the demod state pytree and input blocks at API
   boundaries.  Shape drift cannot corrupt silently under jit (XLA
   retraces), but a retrace IS the failure mode: it recompiles (which
   can take minutes at scale) and masks a caller bug, so the
   boundary assert turns it into an immediate, named error.
 * ``checkify_step`` -- wraps a jitted ``(state, pcm) -> (state, out)``
   step with per-leaf ``jax.experimental.checkify`` finiteness checks
   on everything the step RETURNS: a NaN/Inf escaping into the carried
   state or outputs (diverged fit, unguarded division) raises a
   checked error naming the leaf.  Output-leaf checks rather than
   checkify.float_checks: the pipeline's masked dataflow divides in
   untaken ``jnp.where`` branches by design (e.g. the parabolic-peak
   denominator, dsp/fftops.py), which op-level float checks flag as
   false positives.  Debug tool; production uses
   runtime/failover.health_check (a cheap post-hoc non-finite scan).
"""

from __future__ import annotations

import chex
import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig
from ..modem.rx_production import ProdRxState


def assert_rx_state(cfg: ModemConfig, state: ProdRxState,
                    n_channels: int | None = None) -> None:
    """Validate a (possibly channel-batched) ProdRxState structurally.

    Raises AssertionError naming the offending leaf on any mismatch.
    """
    batch = (n_channels,) if n_channels is not None else ()
    chex.assert_type(state.phase, jnp.complex64)
    chex.assert_type(state.fir_tail, jnp.complex64)
    chex.assert_type(state.decim_prev, jnp.complex64)
    chex.assert_shape(state.phase, batch)
    chex.assert_shape(state.fir_tail, (*batch, cfg.ntaps - 1))
    chex.assert_shape(state.decim_prev,
                      (*batch, cfg.cycles, cfg.symbols_per_block))


def assert_pcm_block(cfg: ModemConfig, pcm, n_channels: int) -> None:
    """Validate one [n_channels, frame_size] int16 input block."""
    chex.assert_shape(pcm, (n_channels, cfg.frame_size))
    if np.dtype(pcm.dtype) != np.int16:
        raise AssertionError(
            f"pcm block must be int16 (got {pcm.dtype}): a float block "
            "silently retraces the jitted step with a different "
            "signature and recompiles")


def checkify_step(step_fn):
    """Wrap a step in per-output-leaf finiteness checks (debug tool).

    Returns ``checked(state, pcm) -> (state, out)`` that RAISES a
    checkify error naming the first returned leaf containing NaN/Inf.
    Example::

        step = checkify_step(lambda st, pcm: prod_rx_frame(cfg, st, pcm))
        state, out = step(state, pcm)   # raises on non-finite output
    """
    from jax.experimental import checkify

    def wrapped(state, pcm):
        result = step_fn(state, pcm)
        leaves = jax.tree_util.tree_leaves_with_path(result)
        for path, leaf in leaves:
            if jnp.issubdtype(leaf.dtype, jnp.inexact):
                checkify.check(
                    jnp.all(jnp.isfinite(leaf)),
                    f"non-finite value in step output leaf "
                    f"{jax.tree_util.keystr(path)}")
        return result

    jitted = jax.jit(checkify.checkify(wrapped,
                                       errors=checkify.user_checks))

    def run(state, pcm):
        err, result = jitted(state, pcm)
        err.throw()
        return result

    return run
