"""Parallel chunk tokenization via finite-state-machine composition.

The decode-side cursor problem (SURVEY.md §7.3): chunk boundaries are
data-dependent, but each chunk's byte length is a pure function of its
first byte (reference qoi.h:547-575):

    0xFE (RGB)  -> 4      0xFF (RGBA) -> 5
    tag 10 (LUMA) -> 2    else (INDEX/DIFF/RUN) -> 1

So "is byte i a chunk start?" is a 5-state FSM over the byte stream, where
the state is bytes-remaining-until-next-chunk-start (0..4):

    s == 0:  s' = len(byte) - 1      (this byte starts a chunk)
    s  > 0:  s' = s - 1

Each byte's transition is a map {0..4} -> {0..4}; maps compose
associatively, so all states resolve with one `lax.associative_scan` over
(N, 5) int8 transition tables — log depth, fully data-parallel, the direct
analog of simdjson-style structural indexing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import format as fmt

_NSTATES = 5


def chunk_byte_len(b: jnp.ndarray) -> jnp.ndarray:
    """Chunk length implied by a first byte (reference qoi.h:547-575)."""
    b = b.astype(jnp.int32)
    two_bit = b & fmt.MASK_2
    return jnp.where(
        b == fmt.OP_RGB, 4,
        jnp.where(b == fmt.OP_RGBA, 5,
                  jnp.where(two_bit == fmt.OP_LUMA, 2, 1)))


def _pack_map(f0):
    """Pack the 5-state map [f0, 0, 1, 2, 3] into base-8 digits of one
    int32: digit s holds f(s). Only state 0's transition depends on the
    byte (s>0 always decrements), so one (M,) int32 array carries every
    map in one contiguous word instead of a (M, 5) layout."""
    const = 0
    for s in range(1, _NSTATES):
        const |= (s - 1) << (3 * s)
    return f0.astype(jnp.int32) | const


def _compose_maps(a, b):
    """b after a: c[s] = b[a[s]], on base-8-packed maps (elementwise)."""
    c = jnp.zeros_like(a)
    for s in range(_NSTATES):
        a_s = (a >> (3 * s)) & 7
        b_of = (b >> (3 * a_s)) & 7
        c = c | (b_of << (3 * s))
    return c


def chunk_starts_and_state(data: jnp.ndarray, chunks_len):
    """(starts, state_before) over the byte stream.

    data: (M,) uint8 chunk bytes (stream minus 14-byte header; may include
    the 8-byte trailer — positions >= chunks_len are never marked, matching
    the reference's `p < chunks_len` read guard, qoi.h:544).
    chunks_len: traced int32 count of real chunk bytes.

    Returns ((M,) bool starts, (M,) int8 bytes-remaining-before-byte-i).
    `state_before[i]` is how many bytes of the current chunk still precede
    the next chunk start at position i (0 = i starts a chunk) — the
    streamed decoder uses it to end tiles exactly at chunk boundaries.
    """
    from . import scans

    m = data.shape[0]
    lens = chunk_byte_len(data)  # (M,)
    trans = _pack_map(lens - 1)  # (M,) int32 packed maps

    # inclusive scan -> composed map after byte i; state after = map[0]
    after = scans.blocked_scan(_compose_maps, trans)
    state_after = (after & 7).astype(jnp.int8)  # start state 0 -> digit 0
    # state BEFORE byte i = state after byte i-1 (0 before byte 0)
    state_before = jnp.concatenate(
        [jnp.zeros((1,), jnp.int8), state_after[:-1]])
    io = jnp.arange(m, dtype=jnp.int32)
    starts = (state_before == 0) & (io < jnp.asarray(chunks_len, jnp.int32))
    return starts, state_before


def chunk_starts(data: jnp.ndarray, chunks_len) -> jnp.ndarray:
    """Boolean chunk-start mask over the byte stream (see
    chunk_starts_and_state)."""
    return chunk_starts_and_state(data, chunks_len)[0]
