"""Streamed single-device encode for huge images (SURVEY §7.5.6).

The reference caps streams at 400M pixels (qoi.h:329-332) — ~1.6 GB of
RGBA input and up to 2 GB of output, too large for the all-at-once
pipeline's intermediates on one chip. Here the stream is processed as a
sequence of fixed-size tiles on one device, chaining the four encoder
carries (EncoderCarry: boundary pixel, pending-run phase, 64-slot table)
through the same plumbing the multi-chip tiled path uses — one compiled
program regardless of image size, O(tile) device memory, byte-identical
output.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..ops import compact, expand
from . import pipeline


class _ProducerError:
    """An exception raised in the upload thread, passed to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@functools.partial(jax.jit, donate_argnums=(0,))
def _enc_tile(out_buf, px4, cursor, off_px, n_total, carry):
    """One device-driven encode tile: encode the (t, 4) tile with the
    incoming carry and write the tile's bytes into the big output buffer
    at the device byte cursor.

    The tile arrives as its OWN device array (uploaded by the
    double-buffering producer thread, so the host-to-device transfer of
    tile k+1 overlaps tile k's program). The write is the full (6t,) staging
    capacity: bytes past the tile's `total` are garbage that the NEXT
    tile's write overwrites (its cursor advances by exactly `total`),
    and the final fetch stops at the last cursor — so no host sync is
    ever needed between tiles."""
    t = px4.shape[0]
    n_valid = jnp.clip(n_total - off_px, 0, t)
    contains_last = n_total <= off_px + t
    ch = pipeline.encode_stage_chunks(
        px4, n_valid,
        prev_in=carry.prev_px, run_in=carry.run,
        table_in=(carry.table, carry.written),
        contains_last=contains_last, form="words")
    buf, total = compact.compact_words6_wordsum(
        ch.lo, ch.hi, ch.lens, t * 6, seg=min(t, 20480))
    out_buf = jax.lax.dynamic_update_slice(out_buf, buf, (cursor,))
    return out_buf, cursor + total, ch.carry


def _fetch_bytes(buf, total: int) -> bytes:
    """Fetch buf[:total] from the device in fixed-shape pieces."""
    from ..utils import fetch

    return fetch.fetch_prefix(buf, total).tobytes()


def encode(pixels: np.ndarray, desc: fmt.StreamDesc,
           tile_px: int = 0, config=None) -> bytes:
    """Encode one image of any size the format allows; byte-identical to
    the reference encoder (qoi.h:356). Device memory stays O(image +
    6*tile); the tile size comes from `tile_px` if nonzero, else
    `config.stream_tile_px`.

    Device-driven tile loop: each tile uploads once, the four encoder
    carries AND the output byte cursor stay device-resident, and every
    tile's bytes land in one big device buffer — the host dispatches all
    tile programs back-to-back with ZERO per-tile syncs, then fetches the
    cursor once and the stream bytes in fixed-shape pieces."""
    if not tile_px:
        tile_px = config.stream_tile_px if config else 1 << 22
    desc.validate()
    px4 = pipeline.force_rgba(pixels, desc)
    n = px4.shape[0]
    t = min(tile_px, pipeline.bucket_size(n))
    n_tiles = -(-n // t)

    # double-buffered upload: a producer thread pads and uploads tiles
    # k+1 and k+2 while tile k's program runs, so the first tile starts
    # after one tile's transfer instead of the whole image's. The queue
    # bound keeps at most ~3 tiles of pixels in flight. A failure in the
    # producer travels through the queue and is re-raised here — a dead
    # producer must not leave the consumer blocked on get() forever.
    import queue as _queue
    import threading

    upq: "_queue.Queue" = _queue.Queue(maxsize=2)
    stop = threading.Event()

    def _producer():
        try:
            for k in range(n_tiles):
                if stop.is_set():
                    return
                piece = px4[k * t: (k + 1) * t]
                if piece.shape[0] < t:
                    piece = np.concatenate(
                        [piece, np.zeros((t - piece.shape[0], 4), np.uint8)])
                arr = jax.device_put(piece)
                # block the PRODUCER until the transfer lands: overlap
                # comes from this thread, not from assuming device_put
                # is async
                jax.block_until_ready(arr)
                upq.put(arr)
        except Exception as e:  # handed to the consumer, re-raised there
            upq.put(_ProducerError(e))

    # output capacity: the TRUE stream worst case is 5 B/px (chunks
    # partition the pixels, each covers >= 1 px and is <= 5 bytes — a
    # run-flush byte is its own RUN chunk covering the run's pixels, so
    # the 6-byte [flush + RGBA] pixel slot never exceeds 5 B/px
    # globally; cross-tile pending runs only DEFER bytes), plus one
    # tile's 6t staging slack for the full-capacity tile writes. The
    # old 6 B/px capacity exceeded 2^31 u8 elements past ~358 Mpx and
    # XLA's s32 index arithmetic corrupts beyond that — the 400 Mpx
    # envelope run caught it (byte mismatch; decode's u32 plane stays
    # under 2^31 and was exact). 5 B/px keeps the format's legal max
    # (400 Mpx, qoi.h:329-332) at ~2.04e9 < 2^31.
    cap = 5 * n_tiles * t + 6 * t
    assert cap < (1 << 31), "encode output buffer exceeds s32 index space"
    out_buf = jnp.zeros((cap,), jnp.uint8)
    carry = pipeline.EncoderCarry.seed()
    cursor = jnp.int32(0)
    producer = threading.Thread(target=_producer, daemon=True)
    producer.start()
    try:
        for k in range(n_tiles):
            px_t = upq.get()
            if isinstance(px_t, _ProducerError):
                raise RuntimeError(
                    f"streamed encode: uploading tile {k} failed") from px_t.exc
            out_buf, cursor, carry = _enc_tile(
                out_buf, px_t, cursor, jnp.int32(k * t), jnp.int32(n), carry)
    finally:
        stop.set()
        while producer.is_alive():  # unblock a producer stuck on put()
            try:
                upq.get(timeout=0.1)
            except _queue.Empty:
                pass
    total = int(jax.device_get(cursor))  # the ONE sync
    return fmt.pack_header(desc) + _fetch_bytes(out_buf, total) + fmt.TRAILER


# ---------------------------------------------------------------------------
# Streamed single-device DECODE for huge images (the reference caps at
# 400M px / ~2 GB streams, qoi.h:329-332 — too large for the all-at-once
# decoder's per-byte int32 intermediates on one chip).
#
# The byte stream is processed as fixed-size tiles ending exactly at chunk
# boundaries (the FSM state at position T-8 says how far the straddling
# chunk extends, ops/fsm.py). Each tile runs the blocked symbolic decoder
# (models/decode_v3.py) with the incoming 65-entry state (px + 64-slot
# table, packed u32) and hands its exit state to the next tile; run
# expansion happens per tile with the tile's entry px as the telescoping
# seed. Non-converging tiles fall back to the sequential scan anchor with
# the same entry state — the decode ladder, tile-local.
# ---------------------------------------------------------------------------

_LOOKBEHIND = 8  # tile stride = tile_bytes - 8; a chunk is at most 5 bytes


@functools.partial(jax.jit, static_argnames=("max_rounds",))
def _decode_tile(data_t, remaining, entry65, max_rounds: int = 12):
    """One byte-tile through the symbolic decoder. data_t: (T,) uint8;
    remaining: traced int32 chunk bytes left in the stream (>= 1).
    Returns (px32 per byte, pix_off, conv, exit65, consumed, n_px_tile)."""
    from .. import format as fmt  # noqa: F401  (kept for parity with encode)
    from ..ops import fsm
    from . import decode_v3 as v3

    t = data_t.shape[0]
    lim = jnp.minimum(remaining, t)
    _, state_before = fsm.chunk_starts_and_state(data_t, lim)
    # end the tile at the chunk boundary at/after T-8: the FSM state there
    # counts the straddling chunk's remaining bytes (<= 4 < _LOOKBEHIND)
    spill = state_before[t - _LOOKBEHIND].astype(jnp.int32)
    consumed = jnp.minimum(t - _LOOKBEHIND + spill, remaining)
    px, starts, npix, pix_off, conv, _, exit65 = v3._decode_core(
        data_t, consumed, max_rounds, entry65)
    n_px_tile = pix_off[-1] + npix[-1]
    return px, pix_off, conv, exit65, consumed, n_px_tile


@functools.partial(jax.jit, static_argnames=("p_cap",))
def _expand_tile(px, pix_off, entry65, p_cap: int):
    return expand.expand_px(pix_off, px, p_cap, seed32=entry65[0])


def _unpack65(entry65: np.ndarray):
    """(65,) packed u32 -> ((4,) u8 px, (64, 4) u8 table)."""
    u8 = np.asarray(entry65, np.uint32).view(np.uint8).reshape(65, 4)
    return u8[0], u8[1:]


def _pack65(px: np.ndarray, table: np.ndarray) -> np.ndarray:
    return np.concatenate([px[None], table]).reshape(65, 4).view(
        np.uint32).reshape(65)


_PX_BUDGET_MIN = 64  # progress guarantee: one chunk yields <= 62 px


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=(
    "t", "p_budget", "max_rounds"))
def _dec_tile_at(plane_all, data_all, cursor, px_cursor, chunks_len,
                 entry65, t: int, p_budget: int, max_rounds: int):
    """One device-driven decode tile: slice t bytes at the device byte
    cursor, end the tile at the last chunk boundary within BOTH the byte
    window (t - 8) and the pixel budget, decode + expand, and write the
    tile's pixels into the big plane at the device pixel cursor.

    The plane write is the full static (p_budget,) capacity: pixels past
    the tile's n_px_tile are repeat-px garbage that the NEXT tile's
    write overwrites (its pixel cursor advances by exactly n_px_tile).
    Returns (plane_all, conv, cursor', px_cursor', exit65) — all device;
    the host never syncs between tiles."""
    from ..ops import fsm, scans
    from . import decode_v3 as v3

    data_t = jax.lax.dynamic_slice(data_all, (cursor,), (t,))
    lim = jnp.clip(chunks_len - cursor, 0, t)
    starts, state_before = fsm.chunk_starts_and_state(data_t, lim)

    # pixels per chunk (RUN emits (b&63)+1, everything else 1)
    b0 = data_t.astype(jnp.int32)
    is_run = ((b0 & fmt.MASK_2) == fmt.OP_RUN) & (b0 < fmt.OP_RGB)
    npix_b = jnp.where(starts, jnp.where(is_run, (b0 & 63) + 1, 1), 0)
    pixexc = scans.exclusive_cumsum(npix_b)

    # byte-window boundary: the chunk boundary at/after t - 8 (the FSM
    # state there counts the straddling chunk's remaining bytes <= 4)
    spill = state_before[t - _LOOKBEHIND].astype(jnp.int32)
    cons_b = jnp.minimum(t - _LOOKBEHIND + spill, lim)
    # tile end = last chunk boundary within BOTH the byte window and the
    # pixel budget; the stream end (lim) is a boundary too, taken only
    # when its pixel total also fits (n_px_tile <= p_budget must hold —
    # the expand plane is a static (p_budget,))
    io = jnp.arange(t, dtype=jnp.int32)
    ok = ((state_before == 0) & (io <= cons_b) & (pixexc <= p_budget)
          & (io <= lim))
    consumed = jnp.max(jnp.where(ok, io, 0))
    tot_pix = pixexc[-1] + npix_b[-1]  # pixels in [0, lim)
    end_ok = (lim <= cons_b) & (tot_pix <= p_budget)
    consumed = jnp.where(end_ok, lim, consumed)

    px, _, npix, pix_off, conv, _, exit65 = v3._decode_core(
        data_t, consumed, max_rounds, entry65)
    n_px_tile = pix_off[-1] + npix[-1]
    conv = conv | (consumed == 0)  # empty tail tiles are trivially done

    plane_t = expand.expand_px(pix_off, px, p_budget, seed32=entry65[0])
    plane_all = jax.lax.dynamic_update_slice(plane_all, plane_t,
                                             (px_cursor,))
    return (plane_all, conv, cursor + consumed, px_cursor + n_px_tile,
            exit65)


def _fetch_words(buf, total: int) -> np.ndarray:
    """Fetch buf[:total] (u32) from the device in fixed-shape pieces."""
    from ..utils import fetch

    return fetch.fetch_prefix(buf, total)


def decode(data: bytes, channels: int = 0, tile_bytes: int = 0,
           max_rounds: int = 0, config=None
           ) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a stream of any size the format allows; pixel-identical to
    the reference decoder (qoi.h:488), including truncation tolerance and
    channel forcing.

    Device-driven tile loop: the stream uploads ONCE, each
    tile is sliced on device at a DEVICE-RESIDENT byte cursor (tiles end
    at the last chunk boundary inside both the byte window and a pixel
    budget, so the expanded plane per tile has a static shape), pixels
    land in one big device plane, and the host dispatches every tile
    optimistically with ZERO per-tile syncs — one combined fetch of the
    per-tile convergence flags at the end. Tiles that did not converge
    (non-canonical streams) are repaired from the first bad tile by the
    host-driven ladder loop (`_decode_host_from`)."""
    from . import decode_pipeline as v1

    if not tile_bytes:
        tile_bytes = config.stream_tile_px if config else 1 << 22
    if not max_rounds:
        max_rounds = config.decode_max_iters if config else 12
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    n_px = desc.num_pixels

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    t = max(1024, tile_bytes)
    p_budget = max(t, _PX_BUDGET_MIN)

    entry65 = np.zeros((65,), np.uint32)
    entry65[0] = np.uint32(
        fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
        | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24)
    entry_dev = jnp.asarray(entry65)

    # upper bound on tiles: each is byte-bound (~t-8 bytes) or pixel-
    # bound (> p_budget - 62 px); +2 covers the trailing partial tile
    n_tiles = (max(chunks_len, 0) // max(t - _LOOKBEHIND, 1)
               + n_px // max(p_budget - 62, 1) + 2)
    data_all = np.zeros((chunks_len + t,), np.uint8)
    m = min(len(chunks), data_all.shape[0])
    data_all[:m] = chunks[:m]
    data_dev = jax.device_put(jnp.asarray(data_all))
    plane_cap = v1.bucket_size(max(n_px, 1)) + p_budget
    plane = jnp.zeros((plane_cap,), jnp.uint32)

    cursor = jnp.int32(0)
    px_cursor = jnp.int32(0)
    entries = []   # per-tile entry state + cursors (device, for repair)
    convs = []
    for _ in range(n_tiles):
        entries.append((cursor, px_cursor, entry_dev))
        plane, conv, cursor, px_cursor, entry_dev = _dec_tile_at(
            plane, data_dev, cursor, px_cursor, jnp.int32(chunks_len),
            entry_dev, t, p_budget, max_rounds)
        convs.append(conv)

    combined = jax.jit(lambda c, pc, bc: (jnp.stack(c), pc, bc))
    convs_h, px_total, byte_total = jax.device_get(
        combined(convs, px_cursor, cursor))
    convs_h = np.asarray(convs_h)
    px_total = int(px_total)
    byte_total = int(byte_total)

    if convs_h.all() and px_total < n_px and byte_total < chunks_len:
        # the static n_tiles bound was exhausted with bytes left over
        # (possible only when the header's pixel total is inconsistent
        # with the byte stream): finish host-driven rather
        # than silently truncation-filling the remainder.
        flat32 = _fetch_words(plane, min(px_total, n_px))
        parts, fill_from = _decode_host_from(
            chunks, chunks_len, byte_total, px_total, entry_dev, n_px,
            t, max_rounds)
        if parts:
            flat32 = np.concatenate([flat32] + parts)[:n_px]
    elif convs_h.all():
        flat32 = _fetch_words(plane, min(px_total, n_px))
        fill_from = entry_dev
    else:
        bad = int(np.argmin(convs_h))
        c0, p0, e0 = entries[bad]
        c0 = int(jax.device_get(c0))
        p0 = int(jax.device_get(p0))
        flat32 = _fetch_words(plane, min(p0, n_px))
        parts, fill_from = _decode_host_from(
            chunks, chunks_len, c0, p0, e0, n_px, t, max_rounds)
        if parts:
            flat32 = np.concatenate([flat32] + parts)[:n_px]
    if flat32.shape[0] < n_px:  # truncated stream: repeat the current px
        fill = np.asarray(jax.device_get(fill_from))[0]
        flat32 = np.concatenate([
            flat32, np.full((n_px - flat32.shape[0],), np.uint32(fill))])
    px4 = np.ascontiguousarray(flat32[:n_px]).view(np.uint8).reshape(-1, 4)
    img = px4[:, :out_ch].reshape(desc.height, desc.width, out_ch)
    return img, desc


def _decode_host_from(chunks, chunks_len, cursor: int, px_cursor: int,
                      entry_dev, n_px: int, t: int, max_rounds: int):
    """Host-driven tile loop: per-tile
    consumed/conv syncs + the tile-local ladder fallback. Used as the
    repair path when the optimistic device-driven loop hits a
    non-converging (non-canonical) tile. Returns (list of (n,) uint32
    plane parts from px_cursor on, final entry state device array)."""
    from . import decode_pipeline as v1
    from . import scan_codec

    parts: list = []
    while cursor < chunks_len and px_cursor < n_px:
        buf = np.zeros((t,), np.uint8)
        span = chunks[cursor: cursor + t]
        buf[: len(span)] = span
        remaining = chunks_len - cursor

        px, pix_off, conv, exit65, consumed, n_px_tile = _decode_tile(
            jnp.asarray(buf), jnp.int32(remaining), entry_dev,
            max_rounds=max_rounds)
        consumed = int(jax.device_get(consumed))
        n_out = min(int(jax.device_get(n_px_tile)), n_px - px_cursor)

        if bool(jax.device_get(conv)):
            if n_out:
                p_cap = v1.bucket_size(n_out)
                plane = _expand_tile(px, pix_off, entry_dev, p_cap)
                parts.append(np.asarray(jax.device_get(plane))[:n_out])
            entry_dev = exit65
        else:
            # tile-local sequential fallback with the same entry state
            e_px, e_table = _unpack65(np.asarray(jax.device_get(entry_dev)))
            p_cap = v1.bucket_size(max(n_out, 1))
            out4, (f_px, f_table) = scan_codec._decode_scan_entry_jit(
                jnp.asarray(buf), p_cap, jnp.int32(consumed),
                jnp.asarray(e_px), jnp.asarray(e_table))
            if n_out:
                parts.append(np.ascontiguousarray(
                    np.asarray(jax.device_get(out4))[:n_out]).view(
                        np.uint32).reshape(-1))
            entry_dev = jnp.asarray(_pack65(
                np.asarray(jax.device_get(f_px)),
                np.asarray(jax.device_get(f_table))))

        cursor += max(consumed, 1)
        px_cursor += n_out

    return parts, entry_dev
