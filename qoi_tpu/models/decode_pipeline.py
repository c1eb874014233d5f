"""Data-parallel QOI decoder v1 (SURVEY §7.3): the cross-check and fallback.

The reference decoder is a sequential chunk-at-a-time state machine with
four loop carries (px, run, index[64], read cursor — qoi.h:540-587). Every
carry is broken into a data-parallel or log-depth stage:

  1. tokenize     5-state FSM composition -> chunk starts      (ops/fsm.py)
  2. fields       per-chunk type/deltas/pixel counts           (parallel)
  3. hash chain   "reset-or-add" affine scan mod 64            (log depth)
  4. table replay last-writer cummax -> INDEX targets          (ops/table.py)
  5. resolve      pointer-doubling over additive copy-chains   (ops/link.py)
  6. expand       run expansion via offset scatter + cummax    (parallel)

Stages 3-5 iterate to a fixpoint certified on-device: the replay is exact
iff the hashes used for table writes equal the hashes of the resolved
pixels (hash is linear mod 64 because 64 | 256, so DIFF/LUMA transitions
are data-independent; INDEX resets follow from the table invariant
index[hash(p)] == p, reference qoi.h:577). Canonical encoder-produced
streams converge in one iteration; alpha-varying or adversarial streams
take a few more; non-convergence falls back to the sequential scan anchor
(models/scan_codec.py), so output always matches the reference decoder.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..ops import fsm, link, scans, table
from . import scan_codec

_SEED = jnp.array(fmt.SEED_PIXEL, dtype=jnp.uint8)
_SEED_HASH = fmt.hash_rgba(*fmt.SEED_PIXEL)
_MAX_FIXPOINT_ITERS = 12


def _chunk_fields(data: jnp.ndarray, start_pos: jnp.ndarray, valid: jnp.ndarray):
    """Gather per-chunk bytes and classify. start_pos: (N,) int32."""
    m = data.shape[0]
    g = lambda off: data[jnp.minimum(start_pos + off, m - 1)]
    b1 = g(0).astype(jnp.int32)
    b2, b3, b4, b5 = g(1), g(2), g(3), g(4)

    is_rgb = (b1 == fmt.OP_RGB) & valid
    is_rgba = (b1 == fmt.OP_RGBA) & valid
    two = b1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & valid
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    npix = jnp.where(is_run, (b1 & 0x3F) + 1, 1) * valid.astype(jnp.int32)

    # mod-256 deltas as the decoder applies them (reference qoi.h:562-572)
    dr = jnp.where(is_diff, ((b1 >> 4) & 3) - 2, 0)
    dg2 = jnp.where(is_diff, ((b1 >> 2) & 3) - 2, 0)
    db = jnp.where(is_diff, (b1 & 3) - 2, 0)
    vg = (b1 & 0x3F) - 32
    lr = vg - 8 + ((b2.astype(jnp.int32) >> 4) & 0x0F)
    lb = vg - 8 + (b2.astype(jnp.int32) & 0x0F)
    dr = jnp.where(is_luma, lr, dr).astype(jnp.uint8)
    dg = jnp.where(is_luma, vg, dg2).astype(jnp.uint8)
    db = jnp.where(is_luma, lb, db).astype(jnp.uint8)

    return dict(
        b1=b1, b2=b2, b3=b3, b4=b4, b5=b5,
        is_rgb=is_rgb, is_rgba=is_rgba, is_index=is_index,
        is_diff=is_diff, is_luma=is_luma, is_run=is_run,
        npix=npix, dr=dr, dg=dg, db=db,
    )


def _initial_hashes(f, valid):
    """Optimistic per-chunk hash-after-chunk via a reset-or-add affine scan
    mod 64 (exact for canonical 3-channel streams; iterated otherwise)."""
    n = valid.shape[0]
    io = jnp.arange(n, dtype=jnp.int32)

    # optimistic alpha for RGB resets: last RGBA literal's alpha, else 255
    last_rgba = scans.cummax(jnp.where(f["is_rgba"], io, -1))
    prev_rgba = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_rgba[:-1]])
    alpha_opt = jnp.where(
        prev_rgba >= 0, f["b5"][jnp.maximum(prev_rgba, 0)].astype(jnp.int32), 255)

    m3, m5, m7, m11 = fmt.HASH_MULTIPLIERS
    i32 = lambda x: x.astype(jnp.int32)
    reset_val = jnp.where(
        f["is_rgba"],
        (m3 * i32(f["b2"]) + m5 * i32(f["b3"]) + m7 * i32(f["b4"]) + m11 * i32(f["b5"])) & 63,
        jnp.where(
            f["is_rgb"],
            (m3 * i32(f["b2"]) + m5 * i32(f["b3"]) + m7 * i32(f["b4"]) + m11 * alpha_opt) & 63,
            f["b1"] & 63,  # INDEX: table invariant => hash == slot
        ),
    )
    is_reset = f["is_rgba"] | f["is_rgb"] | f["is_index"]
    add_val = (m3 * i32(f["dr"]) + m5 * i32(f["dg"]) + m7 * i32(f["db"])) & 63

    r = is_reset.astype(jnp.int32)
    v = jnp.where(is_reset, reset_val, add_val)

    def combine(a, b):  # a earlier, b later
        ra, va = a
        rb, vb = b
        return rb | ra, jnp.where(rb, vb, (va + vb) & 63)

    rs, vs = jax.lax.associative_scan(combine, (r, v))
    return jnp.where(rs == 1, vs, (vs + _SEED_HASH) & 63)


def _resolve_values(f, hashes, valid, start_pos):
    """One replay + pointer-doubling pass given assumed per-chunk hashes."""
    n = valid.shape[0]
    io = jnp.arange(n, dtype=jnp.int32)

    qkeys = jnp.where(f["is_index"], f["b1"] & 63, hashes)
    target1, _ = table.table_replay(
        hashes, (io + 1).astype(jnp.uint32), write=valid, query_keys=qkeys)
    target = target1.astype(jnp.int32) - 1  # -1 => zero table entry

    prev = io - 1  # chunk -1 is the virtual seed root
    parent1 = jnp.where(f["is_index"], target, prev)
    # INDEX into a never-written slot decodes the zero entry (0,0,0,0)
    zero_hit = f["is_index"] & (target < 0)

    anchored_rgb = f["is_rgb"] | f["is_rgba"] | zero_hit | ~valid
    anchored_a = f["is_rgba"] | zero_hit | ~valid
    anchored = jnp.stack(
        [anchored_rgb, anchored_rgb, anchored_rgb, anchored_a], axis=1)

    u8 = lambda x: x.astype(jnp.uint8)
    lit = f["is_rgb"] | f["is_rgba"]
    anchor = jnp.stack([
        jnp.where(lit, u8(f["b2"]), 0),
        jnp.where(lit, u8(f["b3"]), 0),
        jnp.where(lit, u8(f["b4"]), 0),
        jnp.where(f["is_rgba"], u8(f["b5"]), 0),
    ], axis=1)

    delta = jnp.stack(
        [f["dr"], f["dg"], f["db"], jnp.zeros((n,), jnp.uint8)], axis=1)
    parent = jnp.broadcast_to(parent1[:, None], (n, 4))

    return link.resolve(parent, delta, anchored, anchor, _SEED)


def _decode_chunks(data: jnp.ndarray, chunks_len, n_px: int):
    """Full chunk-level decode. data: (M,) uint8 incl. trailer bytes.
    n_px is a static output capacity (callers bucket it; pixels beyond the
    true count are sliced off host-side). Returns ((n_px, 4) uint8, bool)."""
    m = data.shape[0]
    starts = fsm.chunk_starts(data, chunks_len)
    io = jnp.arange(m, dtype=jnp.int32)

    # compact chunk-start positions into record slots (capacity M)
    cid = scans.exclusive_cumsum(starts.astype(jnp.int32))
    slot = jnp.where(starts, cid, m)
    start_pos = jnp.full((m,), m - 1, jnp.int32).at[slot].set(io, mode="drop")
    n_chunks = cid[-1] + starts[-1].astype(jnp.int32)
    valid = jnp.arange(m, dtype=jnp.int32) < n_chunks

    f = _chunk_fields(data, start_pos, valid)

    # fixpoint: hashes -> replay -> values -> hashes
    hashes0 = jnp.where(valid, _initial_hashes(f, valid), 0)

    def body(state):
        hashes, _, _, it = state
        px = _resolve_values(f, hashes, valid, start_pos)
        true_h = jnp.where(valid, table.hash64(px), 0)
        converged = jnp.all(true_h == hashes)
        return true_h, px, converged, it + 1

    def cond(state):
        _, _, converged, it = state
        return ~converged & (it < _MAX_FIXPOINT_ITERS)

    px0 = jnp.zeros((m, 4), jnp.uint8)
    hashes, px, converged, _ = jax.lax.while_loop(
        cond, body, (hashes0, px0, jnp.bool_(False), jnp.int32(0)))
    # the loop exits either converged (px matches hashes) or at the iter cap;
    # run one final resolve so px corresponds to the final hashes
    px = _resolve_values(f, hashes, valid, start_pos)

    # run expansion: pixel -> chunk map via boundary marks + cummax
    pix_off = scans.exclusive_cumsum(f["npix"])
    marks = jnp.full((n_px,), -1, jnp.int32).at[
        jnp.where(valid, pix_off, n_px)].max(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    pixel_chunk = scans.cummax(marks)
    # truncation tolerance (reference qoi.h:544): pixels before any chunk
    # keep the seed; pixels after the last chunk keep the last px
    out = jnp.where(pixel_chunk[:, None] >= 0,
                    px[jnp.maximum(pixel_chunk, 0)], _SEED[None])
    return out, converged


_decode_chunks_jit = jax.jit(_decode_chunks, static_argnums=(2,))


def bucket_size(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_size_fine(n: int, floor: int = 256) -> int:
    """Quarter-power-of-two bucket (2^k * {1, 1.25, 1.5, 1.75}): 4x the
    compiled-shape count for <= 1/7 (~14.3%) worst-case padding — n just
    above 7*(b>>3) rounds to the full pow2 b (pow2 alone wastes up to
    50%). Real 4K streams land ~14 MB -> the pow2 bucket (16.7M) pads
    16% and every decode scan/expand pass pays it. Only used for sizes
    >= 2^20 — big streams, where the padding tax is worth extra compiled
    shapes (4x finer buckets quadruple test-suite compiles) and every
    candidate divides the decode scan blocks; smaller sizes keep pow2
    buckets."""
    if n < (1 << 20):
        return bucket_size(n, floor)
    b = 1 << 20
    while b < n:
        b <<= 1
    for frac in (4, 5, 6, 7):
        cand = (b >> 3) * frac
        if cand >= n:
            return cand
    return b


def decode(data: bytes, channels: int = 0) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream via the parallel pipeline; pixel-identical to the
    reference decoder (qoi.h:488), including truncation tolerance and
    channel forcing. Falls back to the sequential scan anchor on the rare
    non-converged (adversarial) streams."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    cap = bucket_size(len(chunks))
    padded = np.zeros((cap,), np.uint8)
    padded[: len(chunks)] = chunks

    px4, converged = _decode_chunks_jit(
        jnp.asarray(padded), jnp.int32(chunks_len),
        bucket_size(desc.num_pixels))
    if not bool(jax.device_get(converged)):
        return scan_codec.decode(data, channels)
    img = np.asarray(jax.device_get(px4))[: desc.num_pixels, :out_ch]
    return img.reshape(desc.height, desc.width, out_ch), desc
