"""Gather-free parallel QOI decoder (v2) — a cross-check decoder.

The v1 pipeline (models/decode_pipeline.py) is correct but leans on XLA
gathers: chunk-field gathers, INDEX-target gathers, pointer-doubling
rounds. v2 removes every gather and scatter from the resolution loop:

  fields      : per-BYTE shifted arrays (concat shifts) — no record
                compaction at all; non-start bytes are monoid identities
  hash chain  : reset-or-add scan mod 64 at byte granularity
  INDEX values: `ops/table.table_select` — the gather-free last-writer
                VALUE query (brute in-block planes + overwrite scan +
                one-hot select)
  pixel values: per-channel reset-or-add `associative_scan` (DIFF/LUMA
                add mod 256, RGB/RGBA/INDEX reset, RUN identity) — the
                sequential px carry becomes one log-depth scan per round

The only cross-chunk recurrence left is INDEX indirection (a chunk copying
a value that itself came through INDEX). That resolves by a HOST-level
fixpoint: each round is two cached device programs (big tensor families
split from the rest), and px(round k) is exact for every
chunk whose INDEX-nesting depth is < k. Fixpoint + hash consistency is the
same exactness certificate as v1; non-convergence falls back to the v1 /
sequential paths.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..ops import fsm, scans, table
from . import decode_pipeline as v1

_SEED = jnp.array(fmt.SEED_PIXEL, dtype=jnp.uint8)
_MAX_ROUNDS = 12


def _shift_up(x, k):
    """x[i] <- x[i+k]; tail filled with zeros (static k, concat only)."""
    pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
    return jnp.concatenate([x[k:], pad], axis=0)


@jax.jit
def _fields(data: jnp.ndarray, chunks_len: jnp.ndarray):
    """Per-byte chunk fields from shifted arrays. data: (M,) uint8."""
    starts = fsm.chunk_starts(data, chunks_len)
    d1 = data.astype(jnp.int32)
    d2 = _shift_up(data, 1).astype(jnp.int32)
    d3 = _shift_up(data, 2).astype(jnp.int32)
    d4 = _shift_up(data, 3).astype(jnp.int32)
    d5 = _shift_up(data, 4).astype(jnp.int32)

    is_rgb = (d1 == fmt.OP_RGB) & starts
    is_rgba = (d1 == fmt.OP_RGBA) & starts
    two = d1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & starts
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    npix = jnp.where(is_run, (d1 & 0x3F) + 1, 1) * starts.astype(jnp.int32)

    dr = jnp.where(is_diff, ((d1 >> 4) & 3) - 2, 0)
    dg2 = jnp.where(is_diff, ((d1 >> 2) & 3) - 2, 0)
    db = jnp.where(is_diff, (d1 & 3) - 2, 0)
    vg = (d1 & 0x3F) - 32
    lr = vg - 8 + ((d2 >> 4) & 0x0F)
    lb = vg - 8 + (d2 & 0x0F)
    dr = jnp.where(is_luma, lr, dr).astype(jnp.uint8)
    dg = jnp.where(is_luma, vg, dg2).astype(jnp.uint8)
    db = jnp.where(is_luma, lb, db).astype(jnp.uint8)

    # pack per-byte flags/fields into few arrays for cheap inter-program IO
    flags = (starts.astype(jnp.int32)
             | is_rgb.astype(jnp.int32) << 1
             | is_rgba.astype(jnp.int32) << 2
             | is_index.astype(jnp.int32) << 3
             | is_diff.astype(jnp.int32) << 4
             | is_luma.astype(jnp.int32) << 5
             | is_run.astype(jnp.int32) << 6)
    lit = d2 | d3 << 8 | d4 << 16 | d5 << 24   # b2..b5 literal payload
    deltas = (dr.astype(jnp.int32) | dg.astype(jnp.int32) << 8
              | db.astype(jnp.int32) << 16)
    pix_off = scans.exclusive_cumsum(npix)
    return flags, lit, deltas, npix, pix_off


def _unpack_flags(flags):
    return dict(
        starts=(flags & 1) != 0,
        is_rgb=(flags & 2) != 0,
        is_rgba=(flags & 4) != 0,
        is_index=(flags & 8) != 0,
        is_diff=(flags & 16) != 0,
        is_luma=(flags & 32) != 0,
        is_run=(flags & 64) != 0,
    )


def _resolve_scan(f, lit, deltas, idx_val, idx_found):
    """Per-channel reset-or-add scans -> value-after-byte (4, M) uint8,
    channel-major: one contiguous plane per channel.
    idx_val/idx_found: INDEX chunks' table values for this round."""
    m = lit.shape[0]
    b2 = (lit & 0xFF).astype(jnp.uint8)
    b3 = ((lit >> 8) & 0xFF).astype(jnp.uint8)
    b4 = ((lit >> 16) & 0xFF).astype(jnp.uint8)
    b5 = ((lit >> 24) & 0xFF).astype(jnp.uint8)
    dr = (deltas & 0xFF).astype(jnp.uint8)
    dg = ((deltas >> 8) & 0xFF).astype(jnp.uint8)
    db = ((deltas >> 16) & 0xFF).astype(jnp.uint8)

    iv = jnp.where(idx_found, idx_val, 0)  # zero table entry: (0,0,0,0)
    ir = (iv & 0xFF).astype(jnp.uint8)
    ig = ((iv >> 8) & 0xFF).astype(jnp.uint8)
    ib = ((iv >> 16) & 0xFF).astype(jnp.uint8)
    ia = ((iv >> 24) & 0xFF).astype(jnp.uint8)

    lit_rgb = f["is_rgb"] | f["is_rgba"]
    reset_rgb = lit_rgb | f["is_index"]
    reset_a = f["is_rgba"] | f["is_index"]

    rflag = jnp.stack([reset_rgb, reset_rgb, reset_rgb, reset_a], axis=0)
    rval = jnp.stack([
        jnp.where(lit_rgb, b2, ir),
        jnp.where(lit_rgb, b3, ig),
        jnp.where(lit_rgb, b4, ib),
        jnp.where(f["is_rgba"], b5, ia),
    ], axis=0)
    aval = jnp.stack([dr, dg, db, jnp.zeros((m,), jnp.uint8)], axis=0)
    val = jnp.where(rflag, rval, aval)
    rflag = rflag.astype(jnp.uint8)

    def combine(a, bb):
        ra, va = a
        rb, vb = bb
        return jnp.maximum(ra, rb), jnp.where(rb != 0, vb, va + vb)

    rs, vs = scans.blocked_scan(combine, (rflag, val))
    return jnp.where(rs != 0, vs, _SEED[:, None] + vs)  # (4, M) value-after


@jax.jit
def _round_a(data, flags, pxa):
    """Fixpoint round, phase A (the big tensor families): hashes from the
    current value estimate -> table_select locals."""
    f = _unpack_flags(flags)
    # channel-major hash/pack (pxa is (4, M))
    hm = fmt.HASH_MULTIPLIERS
    px32 = pxa.astype(jnp.int32)
    hashes = jnp.where(
        f["starts"],
        (px32[0] * hm[0] + px32[1] * hm[1] + px32[2] * hm[2]
         + px32[3] * hm[3]) & 63, 0)
    qk = jnp.where(f["is_index"], data.astype(jnp.int32) & 63, hashes)
    packed = (px32[0] | px32[1] << 8 | px32[2] << 16 | px32[3] << 24
              ).astype(jnp.uint32)
    return table.table_select_local(hashes, packed, f["starts"], qk), qk


@jax.jit
def _round_b(flags, lit, deltas, qk, local, pxa_prev):
    f = _unpack_flags(flags)
    idx_val, idx_found, _ = table.table_select_carry(local, qk)
    pxa = _resolve_scan(f, lit, deltas, idx_val, idx_found)
    changed = jnp.sum((pxa != pxa_prev).any(axis=0).astype(jnp.int32))
    return pxa, changed


def _decode_v2_device(data, chunks_len, n_px_cap: int):
    """Host-orchestrated decode. Returns (pixels (n_px_cap, 4), converged)."""
    flags, lit, deltas, npix, pix_off = _fields(data, chunks_len)
    f0 = _unpack_flags(flags)

    # round 0: resolve with INDEX treated as zero-entry copies
    pxa = _resolve_scan_jit(flags, lit, deltas,
                            jnp.zeros_like(lit, dtype=jnp.uint32),
                            jnp.zeros_like(flags, dtype=bool))  # (4, M)
    converged = False
    for _ in range(_MAX_ROUNDS):
        local, qk = _round_a(data, flags, pxa)
        pxa, changed = _round_b(flags, lit, deltas, qk, local, pxa)
        if int(jax.device_get(changed)) == 0:
            converged = True
            break

    pixels = _expand_jit(flags, pxa, npix, pix_off, n_px_cap)
    return pixels, converged


@jax.jit
def _resolve_scan_wrap(flags, lit, deltas, iv, ifound):
    return _resolve_scan(_unpack_flags(flags), lit, deltas, iv, ifound)


_resolve_scan_jit = _resolve_scan_wrap


@functools.partial(jax.jit, static_argnames=("n_px_cap",))
def _expand(flags, pxa, npix, pix_off, n_px_cap: int):
    """Run expansion: chunk boundary marks + cummax + one value gather."""
    f = _unpack_flags(flags)
    m = flags.shape[0]
    io = jnp.arange(m, dtype=jnp.int32)
    marks = jnp.full((n_px_cap,), -1, jnp.int32).at[
        jnp.where(f["starts"], pix_off, n_px_cap)].max(io, mode="drop")
    pixel_byte = scans.cummax(marks)
    idx = jnp.maximum(pixel_byte, 0)
    ok = pixel_byte >= 0
    # per-channel gathers from the channel-major planes
    out = jnp.stack([
        jnp.where(ok, pxa[c][idx], _SEED[c]) for c in range(4)
    ], axis=0)
    return out  # (4, n_px_cap)


_expand_jit = _expand


@jax.jit
def _fields_batch(data, chunks_len):
    return jax.vmap(_fields)(data, chunks_len)


@jax.jit
def _resolve0_batch(flags, lit, deltas):
    return jax.vmap(lambda f, l, d: _resolve_scan_jit(
        f, l, d, jnp.zeros_like(l, dtype=jnp.uint32),
        jnp.zeros_like(f, dtype=bool)))(flags, lit, deltas)


@jax.jit
def _round_a_batch(data, flags, pxa):
    return jax.vmap(_round_a)(data, flags, pxa)


@jax.jit
def _round_b_batch(flags, lit, deltas, qk, local, pxa):
    pxa2, changed = jax.vmap(_round_b)(flags, lit, deltas, qk, local, pxa)
    return pxa2, jnp.sum(changed)


@functools.partial(jax.jit, static_argnames=("n_px_cap",))
def _expand_batch(flags, pxa, npix, pix_off, n_px_cap: int):
    return jax.vmap(
        lambda f, p, n, o: _expand(f, p, n, o, n_px_cap))(
        flags, pxa, npix, pix_off)


def decode_group(data: jnp.ndarray, chunks_len: jnp.ndarray, n_px_cap: int):
    """Batched device decode for same-bucket streams. data: (B, M) uint8;
    chunks_len: (B,) int32. Returns (pixels (B, 4, n_px_cap), converged
    bool — rounds are idempotent per converged stream, so a group fixpoint
    certifies every stream)."""
    flags, lit, deltas, npix, pix_off = _fields_batch(data, chunks_len)
    pxa = _resolve0_batch(flags, lit, deltas)
    converged = False
    for _ in range(_MAX_ROUNDS):
        local, qk = _round_a_batch(data, flags, pxa)
        pxa, changed = _round_b_batch(flags, lit, deltas, qk, local, pxa)
        if int(jax.device_get(changed)) == 0:
            converged = True
            break
    return _expand_batch(flags, pxa, npix, pix_off, n_px_cap), converged


def decode(data: bytes, channels: int = 0) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream via the gather-free pipeline; pixel-identical to
    the reference decoder (qoi.h:488). Falls back to the v1 pipeline (which
    itself falls back to the sequential anchor) on non-convergence."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    cap = v1.bucket_size(len(chunks))
    padded = np.zeros((cap,), np.uint8)
    padded[: len(chunks)] = chunks

    px4, converged = _decode_v2_device(
        jnp.asarray(padded), jnp.int32(chunks_len),
        v1.bucket_size(desc.num_pixels))
    if not converged:
        return v1.decode(data, channels)
    img = np.asarray(jax.device_get(px4)).T[: desc.num_pixels, :out_ch]
    return img.reshape(desc.height, desc.width, out_ch), desc
