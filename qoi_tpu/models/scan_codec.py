"""Sequential JAX codec: the reference recurrence as a `lax.scan`.

This is the bit-exactness *anchor* (SURVEY.md §7.4 step 2): a literal
transcription of the per-pixel state machines (encoder: reference
qoi.h:406-478; decoder: qoi.h:540-587) into a single-step-per-pixel scan.
It is deliberately sequential — O(N) scan steps — and exists so that every
stage of the parallel pipeline (qoi_tpu/models/pipeline.py) can be
differentially tested against something independently trustworthy on-device.

All chunk-emission logic here works in uint8/int8 with mod-256 wraparound,
matching the C `signed char` semantics (SURVEY.md §2.2.4).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt

_SEED = jnp.array(fmt.SEED_PIXEL, dtype=jnp.uint8)


def _hash64(px: jnp.ndarray) -> jnp.ndarray:
    """Color-table slot (reference qoi.h:92-94). px: (..., 4) uint8.
    Elementwise multiply-adds (fmt.hash_px), never a dot: see
    ops/table.hash64."""
    return fmt.hash_px(px.astype(jnp.int32)) & 63


def classify_literal(px: jnp.ndarray, px_prev: jnp.ndarray):
    """Op selection for a non-run, table-miss pixel (reference qoi.h:438-474).

    Returns (bytes5, length) where bytes5 is the chunk padded to 5 bytes.
    Works elementwise over leading batch dims; px/px_prev: (..., 4) uint8.
    """
    # mod-256 deltas reinterpreted as signed char (reference qoi.h:439-444)
    d = (px[..., :3] - px_prev[..., :3]).astype(jnp.int8)
    vr, vg, vb = d[..., 0], d[..., 1], d[..., 2]
    vg_r = (vr - vg).astype(jnp.int8)
    vg_b = (vb - vg).astype(jnp.int8)
    alpha_same = px[..., 3] == px_prev[..., 3]

    small = lambda v: (v >= -2) & (v <= 1)
    is_diff = alpha_same & small(vr) & small(vg) & small(vb)
    is_luma = (
        alpha_same & ~is_diff
        & (vg >= -32) & (vg <= 31)
        & (vg_r >= -8) & (vg_r <= 7)
        & (vg_b >= -8) & (vg_b <= 7)
    )
    is_rgb = alpha_same & ~is_diff & ~is_luma

    i16 = lambda v: v.astype(jnp.int16)  # avoid int8 overflow in bias adds
    diff_b0 = (fmt.OP_DIFF | (i16(vr) + 2) << 4 | (i16(vg) + 2) << 2 | (i16(vb) + 2)).astype(jnp.uint8)
    luma_b0 = (fmt.OP_LUMA | (i16(vg) + 32)).astype(jnp.uint8)
    luma_b1 = ((i16(vg_r) + 8) << 4 | (i16(vg_b) + 8)).astype(jnp.uint8)

    r, g, b, a = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    u8 = lambda x: jnp.asarray(x, dtype=jnp.uint8)
    zeros = jnp.zeros_like(r)

    b0 = jnp.where(is_diff, diff_b0,
         jnp.where(is_luma, luma_b0,
         jnp.where(is_rgb, u8(fmt.OP_RGB), u8(fmt.OP_RGBA))))
    b1 = jnp.where(is_diff, zeros, jnp.where(is_luma, luma_b1, r))
    b2 = jnp.where(is_diff | is_luma, zeros, g)
    b3 = jnp.where(is_diff | is_luma, zeros, b)
    b4 = jnp.where(is_rgb | is_diff | is_luma, zeros, a)
    length = jnp.where(is_diff, 1, jnp.where(is_luma, 2, jnp.where(is_rgb, 4, 5))).astype(jnp.int32)
    return jnp.stack([b0, b1, b2, b3, b4], axis=-1), length


def _encode_scan(pixels4: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scan over pixels; per pixel emit up to 6 bytes (run-flush + chunk).

    pixels4: (N, 4) uint8, alpha pre-forced to 255 for 3-channel input
    (reference qoi.h:411-413). Returns (staging (N, 6) uint8, lens (N,)).
    """
    n = pixels4.shape[0]

    def step(carry, inp):
        px_prev, run, table = carry
        px, is_last = inp

        eq = jnp.all(px == px_prev)

        # --- run branch (reference qoi.h:415-421)
        run_inc = run + 1
        emit_run_here = eq & ((run_inc == fmt.RUN_CAP) | is_last)
        run_after_eq = jnp.where(emit_run_here, 0, run_inc)

        # --- literal branch (reference qoi.h:422-474)
        flush = (~eq) & (run > 0)
        slot = _hash64(px)
        hit = jnp.all(table[slot] == px)
        lit_bytes, lit_len = classify_literal(px, px_prev)
        idx_byte = (fmt.OP_INDEX | slot).astype(jnp.uint8)
        own_bytes = jnp.where(hit, jnp.concatenate([idx_byte[None], jnp.zeros(4, jnp.uint8)]), lit_bytes)
        own_len = jnp.where(hit, 1, lit_len)
        # store-on-miss before op choice (reference qoi.h:436)
        new_table = jnp.where(eq | hit, table, table.at[slot].set(px))

        run_byte_eq = (fmt.OP_RUN | (run_inc - 1)).astype(jnp.uint8)
        run_byte_flush = (fmt.OP_RUN | (run - 1)).astype(jnp.uint8)

        out_bytes = jnp.where(
            eq,
            jnp.concatenate([run_byte_eq[None], jnp.zeros(5, jnp.uint8)]),
            jnp.concatenate([jnp.where(flush, run_byte_flush, own_bytes[0])[None],
                             jnp.where(flush, own_bytes[:5], jnp.concatenate([own_bytes[1:], jnp.zeros(1, jnp.uint8)]))]),
        )
        out_len = jnp.where(
            eq, jnp.where(emit_run_here, 1, 0), own_len + jnp.where(flush, 1, 0)
        )

        new_run = jnp.where(eq, run_after_eq, 0)
        return (px, new_run, new_table), (out_bytes, out_len)

    is_last = jnp.zeros((n,), dtype=bool).at[n - 1].set(True)
    init = (_SEED, jnp.int32(0), jnp.zeros((64, 4), jnp.uint8))
    _, (staging, lens) = jax.lax.scan(step, init, (pixels4, is_last))
    return staging, lens


_encode_scan_jit = jax.jit(_encode_scan)


def encode(pixels: np.ndarray, desc: fmt.StreamDesc) -> bytes:
    """Encode via the scan anchor; byte-identical to the reference encoder."""
    desc.validate()
    flat = np.asarray(pixels, dtype=np.uint8).reshape(-1, desc.channels)
    if flat.shape[0] != desc.num_pixels:
        raise ValueError("pixel count mismatch")
    if desc.channels == 3:
        px4 = np.concatenate([flat, np.full((flat.shape[0], 1), 255, np.uint8)], axis=1)
    else:
        px4 = flat
    staging, lens = jax.device_get(_encode_scan_jit(jnp.asarray(px4)))
    # host-side compaction (anchor path only; the parallel pipeline compacts
    # on device)
    body = staging[np.arange(6)[None, :] < lens[:, None]]
    return fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER


def _decode_scan(data: jnp.ndarray, n_px: int, chunks_len,
                 entry_px=None, entry_table=None):
    """Scan over output pixels (reference qoi.h:540-587). data: padded uint8
    stream starting at the first chunk byte; chunks_len: bytes before trailer
    (traced ok). `entry_px` (4,) u8 / `entry_table` (64, 4) u8 chain tile
    state for the streamed decoder; returns (pixels (n_px, 4),
    (exit_px, exit_table))."""

    def step(carry, _):
        px, run, table, p = carry

        has_chunk = (run == 0) & (p < chunks_len)
        b1 = data[jnp.minimum(p, data.shape[0] - 1)].astype(jnp.int32)
        b2 = data[jnp.minimum(p + 1, data.shape[0] - 1)]
        b3 = data[jnp.minimum(p + 2, data.shape[0] - 1)]
        b4 = data[jnp.minimum(p + 3, data.shape[0] - 1)]
        b5 = data[jnp.minimum(p + 4, data.shape[0] - 1)]

        is_rgb = b1 == fmt.OP_RGB
        is_rgba = b1 == fmt.OP_RGBA
        two_bit = b1 & fmt.MASK_2
        is_index = ~is_rgb & ~is_rgba & (two_bit == fmt.OP_INDEX)
        is_diff = ~is_rgb & ~is_rgba & (two_bit == fmt.OP_DIFF)
        is_luma = ~is_rgb & ~is_rgba & (two_bit == fmt.OP_LUMA)
        is_run = ~is_rgb & ~is_rgba & (two_bit == fmt.OP_RUN)

        # additive ops in uint8 (mod-256, reference qoi.h:562-572)
        dr2 = (((b1 >> 4) & 3) - 2).astype(jnp.uint8)
        dg2 = (((b1 >> 2) & 3) - 2).astype(jnp.uint8)
        db2 = ((b1 & 3) - 2).astype(jnp.uint8)
        vg = ((b1 & 0x3F) - 32).astype(jnp.uint8)
        lr = (vg - 8 + ((b2.astype(jnp.int32) >> 4) & 0x0F).astype(jnp.uint8)).astype(jnp.uint8)
        lb = (vg - 8 + (b2.astype(jnp.int32) & 0x0F).astype(jnp.uint8)).astype(jnp.uint8)

        px_rgb = jnp.stack([b2, b3, b4, px[3]])
        px_rgba = jnp.stack([b2, b3, b4, b5])
        px_index = table[b1 & 63]
        px_diff = px + jnp.stack([dr2, dg2, db2, jnp.uint8(0)])
        px_luma = px + jnp.stack([lr, vg, lb, jnp.uint8(0)])

        new_px = jnp.where(is_rgb, px_rgb,
                 jnp.where(is_rgba, px_rgba,
                 jnp.where(is_index, px_index,
                 jnp.where(is_diff, px_diff,
                 jnp.where(is_luma, px_luma, px)))))
        new_px = jnp.where(has_chunk, new_px, px)

        advance = jnp.where(is_rgb, 4, jnp.where(is_rgba, 5, jnp.where(is_luma, 2, 1)))
        new_p = jnp.where(has_chunk, p + advance, p)
        new_run = jnp.where(
            has_chunk,
            jnp.where(is_run, b1 & 0x3F, 0),
            jnp.maximum(run - 1, 0),
        )
        # table refresh after EVERY chunk (reference qoi.h:577)
        new_table = jnp.where(has_chunk, table.at[_hash64(new_px)].set(new_px), table)
        return (new_px, new_run, new_table, new_p), new_px

    init = (
        _SEED if entry_px is None else jnp.asarray(entry_px, jnp.uint8),
        jnp.int32(0),
        (jnp.zeros((64, 4), jnp.uint8) if entry_table is None
         else jnp.asarray(entry_table, jnp.uint8)),
        jnp.int32(0),
    )
    final, out = jax.lax.scan(step, init, None, length=n_px)
    return out, (final[0], final[2])


_decode_scan_jit = jax.jit(
    lambda data, n_px, chunks_len: _decode_scan(data, n_px, chunks_len)[0],
    static_argnums=(1,))
_decode_scan_entry_jit = jax.jit(_decode_scan, static_argnums=(1,))


def decode(data: bytes, channels: int = 0) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode via the scan anchor; pixel-identical to the reference decoder,
    including truncation tolerance and channel forcing."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    px4 = jax.device_get(_decode_scan_jit(jnp.asarray(chunks), desc.num_pixels, chunks_len))
    img = px4[:, :out_ch].reshape(desc.height, desc.width, out_ch)
    return img, desc
