"""DVB additive bit scrambler, vectorized.

The reference scrambles two bits per call through a sequential 15-bit
LFSR (reference: src/scramble.c:57-68).  Because the LFSR is autonomous
(feedback never touches the data), scrambling == XOR with a fixed
periodic keystream, so the whole operation is a vectorized XOR
against a precomputed mask table -- no per-bit loop, and it batches
trivially over channels.  Scramble and descramble are the same
operation (additive scrambler), matching the reference's intent of
symmetric TX scramble / RX descramble (the reference left the TX side
commented out -- src/qpsk.c:386, 397 -- a documented deviation, see
SURVEY.md section 2 quirk #3).

State per stream = a single integer offset into the keystream (the
reference's 15-bit register content is equivalent information:
register-after-n-steps is a pure function of n).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constants import SCRAMBLE_PERIOD, scramble_dibit_mask


def dibit_masks(offset, count: int, *, seed: int = 0x4A80):
    """XOR masks for ``count`` consecutive dibits starting at ``offset``.

    ``offset`` counts dibits (2 LFSR steps each) and may be a traced
    scalar; the table lookup wraps at the keystream period.
    """
    table = jnp.asarray(scramble_dibit_mask(seed))
    idx = (offset + jnp.arange(count)) % SCRAMBLE_PERIOD
    return table[idx]


def scramble_dibits(dibits, offset, *, seed: int = 0x4A80):
    """(De)scramble dibits [..., count]; returns (out, new_offset).

    Matches ``scramble(&dibit, reg)`` applied ``count`` times
    (src/scramble.c:74-84).  Works under jit/vmap: ``offset`` may be a
    per-channel traced int32.
    """
    count = dibits.shape[-1]
    masks = dibit_masks(offset, count, seed=seed)
    return jnp.bitwise_xor(dibits, masks), (offset + count) % SCRAMBLE_PERIOD


def scramble_bits(bits, offset_bits, *, seed: int = 0x4A80):
    """(De)scramble a flat bit array at a bit-granular keystream offset."""
    from .constants import scramble_keystream

    table = jnp.asarray(scramble_keystream(seed))
    n = bits.shape[-1]
    period = table.shape[0]
    idx = (offset_bits + jnp.arange(n)) % period
    return jnp.bitwise_xor(bits, table[idx]), (offset_bits + n) % period


def reference_lfsr_state(offset_dibits: int, *, seed: int = 0x4A80) -> int:
    """The C register content after ``offset_dibits`` dibits (debug aid)."""
    mem = seed
    for _ in range(2 * offset_dibits):
        o = ((mem >> 1) & 1) ^ (mem & 1)
        mem = (mem >> 1) | (o << 14)
    return mem


__all__ = [
    "dibit_masks",
    "scramble_dibits",
    "scramble_bits",
    "reference_lfsr_state",
    "SCRAMBLE_PERIOD",
]
