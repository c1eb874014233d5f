"""Scan-shaped primitives: run segmentation and prefix sums.

These break the `run` loop-carry of the reference encoder (qoi.h:415-428)
into data-parallel form (SURVEY.md §7.2 stage 1): run membership is a
cumulative-max over "last non-equal pixel index", and all RUN-chunk emission
points follow from positions within a run modulo the 62-cap.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import format as fmt


#: route the big 1-D cumulative ops through blocked_scan (ONE pass over
#: device memory) instead of jnp.cumsum / lax.cummax. Whether XLA's own
#: cumulative ops beat it on a given device is not yet measured; the flag
#: is the switch for that comparison.
_BLOCKED_CUM = True


def exclusive_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    if _BLOCKED_CUM and axis in (-1, x.ndim - 1):
        inc = blocked_scan(lambda a, b: a + b, x)
    else:
        inc = jnp.cumsum(x, axis=axis)
    return inc - x


def cummax(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inclusive cumulative max over `axis` (see _BLOCKED_CUM)."""
    if _BLOCKED_CUM and axis in (-1, x.ndim - 1):
        return blocked_scan(jnp.maximum, x)
    return jax.lax.cummax(x, axis=axis if axis >= 0 else x.ndim + axis)


def chunked_assoc_scan(combine, elems, seg: int = 1 << 16):
    """Inclusive `associative_scan` over axis -1 of a pytree, hierarchical:
    within-segment scans under `lax.map` + one small cross-segment scan +
    an elementwise prefix application.

    A flat `lax.associative_scan` over tens of millions of elements makes
    a very large compiled graph; the chunked form keeps every compiled
    graph segment-sized. Semantically identical for associative
    `combine`.
    """
    leaves = jax.tree.leaves(elems)
    n = leaves[0].shape[-1]
    if n <= seg * 2:
        return jax.lax.associative_scan(combine, elems, axis=-1)
    ns = -(-n // seg)
    pad = ns * seg - n

    def to_seg(x):
        # pad by repeating the last element: padding never changes the
        # prefix of real positions and keeps segment totals well-defined
        x = jnp.concatenate([x, jnp.repeat(x[..., -1:], pad, axis=-1)], axis=-1)
        return x.reshape(x.shape[:-1] + (ns, seg))

    seg_elems = jax.tree.map(to_seg, elems)
    # within-segment inclusive scans, one segment per lax.map step
    moved = jax.tree.map(lambda x: jnp.moveaxis(x, -2, 0), seg_elems)
    within = jax.lax.map(
        lambda e: jax.lax.associative_scan(combine, e, axis=-1), moved)
    totals = jax.tree.map(lambda x: x[..., -1], within)  # (ns, ...)
    # exclusive cross-segment composition (tiny)
    incl = jax.lax.associative_scan(combine, totals, axis=0)
    # excl[0] is a placeholder (segment 0's raw scan is kept below)
    excl = jax.tree.map(
        lambda t, i: jnp.concatenate([t[:1], i[:-1]], axis=0), totals, incl)

    prefixed = combine(
        jax.tree.map(lambda e: jnp.expand_dims(e, -1), excl), within)
    # segment 0 must keep its raw within-scan (no incoming prefix)
    out = jax.tree.map(
        lambda p, w: jnp.concatenate([w[:1], p[1:]], axis=0), prefixed, within)
    back = jax.tree.map(
        lambda x: jnp.moveaxis(x, 0, -2).reshape(
            x.shape[1:-1] + (ns * seg,))[..., :n], out)
    return back


#: lax.scan unroll factor for the blocked scans: bigger loop bodies lose
#: more to scheduling than the per-step bookkeeping costs.
_UNROLL = 1

#: default elements-per-lane of blocked_scan == its lax.scan step count;
#: the sequential steps are latency-bound regardless of lane width, so
#: smaller blocks trade step count for wider per-step rows.
_BLOCK = 512


def blocked_scan(combine, elems, block: int = 0, unroll: int = 0):
    """Inclusive associative scan over axis -1, as a vmapped `lax.scan`:

      1. lax.scan over position-in-block (lanes = blocks): the running
         combine stays in registers, so the data makes ONE pass through
         device memory (a log-depth `associative_scan` re-reads the
         operands ~2*log2(n) times);
      2. cross-block totals: one small associative_scan over n/block;
      3. elementwise prefix fixup.

    Semantically identical to `chunked_assoc_scan` for associative
    `combine`; `combine` must broadcast leading dims (all jnp elementwise
    combines do).
    """
    block = block or _BLOCK
    leaves = jax.tree.leaves(elems)
    n = leaves[0].shape[-1]
    if n <= block * 4:
        return jax.lax.associative_scan(combine, elems, axis=-1)
    nb = -(-n // block)
    pad = nb * block - n

    def to_blocks(x):
        # pad by repeating the last element: padding follows every real
        # position, so their inclusive prefixes are unchanged
        if pad:
            x = jnp.concatenate(
                [x, jnp.repeat(x[..., -1:], pad, axis=-1)], axis=-1)
        x = x.reshape(x.shape[:-1] + (nb, block))
        return jnp.moveaxis(x, -1, 0)  # (block, ..., nb)

    xs = jax.tree.map(to_blocks, elems)
    first = jax.tree.map(lambda x: x[0], xs)
    rest = jax.tree.map(lambda x: x[1:], xs)

    def step(carry, x):
        nxt = combine(carry, x)
        return nxt, nxt

    totals, ys_rest = jax.lax.scan(step, first, rest,
                                   unroll=unroll or _UNROLL)
    ys = jax.tree.map(
        lambda f, y: jnp.concatenate([f[None], y], axis=0), first, ys_rest)

    # cross-block inclusive totals -> exclusive prefix per block
    incl = jax.lax.associative_scan(combine, totals, axis=-1)
    excl = jax.tree.map(
        lambda t, i: jnp.concatenate([t[..., :1], i[..., :-1]], axis=-1),
        totals, incl)
    fixed = combine(jax.tree.map(lambda e: e[None], excl), ys)
    out = jax.tree.map(
        lambda y, f: jnp.concatenate([y[..., :1], f[..., 1:]], axis=-1),
        ys, fixed)

    def back(x):
        x = jnp.moveaxis(x, 0, -1)  # (..., nb, block)
        return x.reshape(x.shape[:-2] + (nb * block,))[..., :n]

    return jax.tree.map(back, out)


def last_true_index(mask: jnp.ndarray) -> jnp.ndarray:
    """For each i (last axis), the largest j <= i with mask[j], else -1."""
    n = mask.shape[-1]
    io = jnp.arange(n, dtype=jnp.int32)
    io = jnp.broadcast_to(io, mask.shape)
    return cummax(jnp.where(mask, io, -1), axis=mask.ndim - 1)


class RunInfo(NamedTuple):
    """Per-pixel run bookkeeping. All arrays share the input's shape."""

    emits_run: jnp.ndarray   # bool: this eq-pixel emits a RUN chunk here
    run_val: jnp.ndarray     # int32: RUN length emitted (valid iff emits_run)
    flush: jnp.ndarray       # bool: literal pixel preceded by a pending run
    flush_val: jnp.ndarray   # int32: pending run length (valid iff flush)


def run_segmentation(eq: jnp.ndarray, last_pos=None, run_in=None) -> RunInfo:
    """Resolve every RUN-chunk emission point from the equality mask.

    eq[i] means pixel i equals pixel i-1 (pixel -1 being the seed, or the
    incoming boundary pixel in tiled strict mode). The reference emits a RUN
    when the accumulator hits 62 or at the last pixel (qoi.h:417), and
    flushes a pending run before any literal (qoi.h:425-428). run position =
    distance to the last non-eq pixel; since a run resets at every 62nd
    member, emission points are run positions ≡ 0 (mod 62).

    `last_pos` overrides the index of the stream's final pixel (default
    n-1; pass -1 for "not in this tile"), for shape-bucketed buffers whose
    logical length is a traced scalar and for non-final tiles.

    `run_in` (traced int32 in [0, 61], broadcastable over batch dims) is the
    pending not-yet-emitted run length entering this tile (SURVEY §7.2
    stage 5: the 62-flush phase must carry across tile boundaries). The
    leading all-eq prefix continues that run, and a leading literal flushes
    it.
    """
    n = eq.shape[-1]
    io = jnp.arange(n, dtype=jnp.int32)
    io = jnp.broadcast_to(io, eq.shape)
    # for a prefix that is all-eq (pixels equal to the seed), last_noneq = -1
    # and run_pos = i + 1: the seed run starts at pixel 0 (SURVEY §2.2 note)
    last_noneq = last_true_index(~eq)
    run_pos = io - last_noneq
    if run_in is None:
        run_in = jnp.int32(0)
    else:
        run_in = jnp.asarray(run_in, jnp.int32)
    # the leading run continues the incoming pending run
    run_pos = run_pos + jnp.where(last_noneq == -1, run_in[..., None], 0)

    is_last = io == (jnp.asarray(n - 1 if last_pos is None else last_pos)[..., None])
    emits_run = eq & ((run_pos % fmt.RUN_CAP == 0) | is_last)
    run_val = (run_pos - 1) % fmt.RUN_CAP + 1

    prev_eq = jnp.roll(eq, 1, axis=-1).at[..., 0].set(run_in > 0)
    prev_run_pos = jnp.roll(run_pos, 1, axis=-1).at[..., 0].set(run_in)
    flush = (~eq) & prev_eq & (prev_run_pos % fmt.RUN_CAP != 0)
    flush_val = (prev_run_pos - 1) % fmt.RUN_CAP + 1
    return RunInfo(emits_run, run_val, flush, flush_val)
