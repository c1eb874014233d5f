"""Data-parallel QOI encoder: the flagship device pipeline (SURVEY.md §7.2).

The reference encoder is a sequential per-pixel state machine with four
loop carries (px_prev, run, index[64], write cursor — qoi.h:406-478). Here
every carry is broken into a data-parallel or log-depth stage:

  1. pixel prep       px_prev = shift(px);  eq mask          (parallel)
  2. run segmentation cummax distance-to-last-literal        (log depth)
  3. table replay     last-writer-wins overwrite scan        (ops/table.py)
  4. classification   DIFF/LUMA/RGB/RGBA wraparound int8     (parallel)
  5. offsets          exclusive prefix sum of chunk lengths  (log depth)
  6. compaction       word-sum placement                     (ops/compact.py)

Every stage is differentially tested against the scan anchor
(models/scan_codec.py) and the C++ oracle. Output is byte-identical to the
reference encoder for any input.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..ops import compact, scans, table
from ..utils import profiling

_SEED = jnp.array(fmt.SEED_PIXEL, dtype=jnp.uint8)


def _swar_add(a: jnp.ndarray, b) -> jnp.ndarray:
    """Per-byte mod-256 add of 4x-u8-packed uint32 lanes (masked halves
    keep carries in the zero gaps; same as models/decode_v3)."""
    m2 = jnp.uint32(0xFF00FF00)
    lo = ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF
    hi = ((a & m2) + (b & m2)) & m2
    return lo | hi


def _swar_sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-byte mod-256 subtract of 4x-u8-packed uint32 lanes (no
    cross-byte borrow): ((a | H) - (b & ~H)) ^ ((a ^ ~b) & H)."""
    h = jnp.uint32(0x80808080)
    return ((a | h) - (b & ~h)) ^ ((a ^ ~b) & h)


class EncoderCarry(NamedTuple):
    """The four loop carries of the reference encoder (qoi.h:406-478) at a
    tile boundary, for chaining tiles sequentially (models/streamed.py) or
    across devices (parallel/tiled.py)."""

    prev_px: jnp.ndarray  # (4,) uint8 last pixel of the tile
    run: jnp.ndarray      # int32 pending (unemitted) run length, 0..61
    table: jnp.ndarray    # (64,) uint32 packed table values
    written: jnp.ndarray  # (64,) bool slots ever written

    @classmethod
    def seed(cls) -> "EncoderCarry":
        return cls(_SEED, jnp.int32(0),
                   jnp.zeros((64,), jnp.uint32), jnp.zeros((64,), bool))


class EncodedChunks(NamedTuple):
    """Per-pixel chunk staging before compaction."""

    staging: jnp.ndarray  # (6, N) uint8 byte planes: [flush?] + chunk bytes
    lens: jnp.ndarray     # (N,) int32 emitted byte count (0 for run members)
    carry: EncoderCarry   # outgoing boundary state after the valid region


class EncodedWords(NamedTuple):
    """Per-pixel chunk staging in packed word form (form='words'): the
    exact (lo, hi) layout ops/compact._record_words derives from the
    byte planes, emitted directly by the classifier — no (6, N) staging
    materialization, no repack."""

    lo: jnp.ndarray    # (N,) uint32 stream bytes 0..3, little-endian
    hi: jnp.ndarray    # (N,) uint32 stream bytes 4..5 in the low 16 bits
    lens: jnp.ndarray  # (N,) int32 emitted byte count (0 for run members)
    carry: EncoderCarry


def encode_stage_chunks(
    px4: jnp.ndarray,
    n_valid=None,
    *,
    prev_in=None,
    run_in=None,
    table_in=None,
    contains_last=None,
    table_block: int = table._BLOCK,
    form: str = "bytes",
) -> EncodedChunks:
    """Stages 1-4: per-pixel chunk bytes + lengths, fully data-parallel.

    px4: (N, 4) uint8 with alpha forced to 255 for 3-channel sources
    (reference qoi.h:411-413). `n_valid` (traced scalar or None) supports
    shape bucketing: positions >= n_valid are padding and emit nothing —
    they are forced onto the run branch (eq) so they never write the table,
    and their emission/flush points are masked off.

    Tiled strict mode (SURVEY §7.2 stage 5) passes the incoming
    cross-tile carry state:
      prev_in:  (4,) uint8 boundary pixel (default: the seed pixel);
      run_in:   traced int32 pending run length entering the tile;
      table_in: (table (64,) uint32 packed, written (64,) bool);
      contains_last: traced bool — whether this tile holds the stream's
        final pixel (controls the end-of-stream run flush, qoi.h:417).
    """
    n = px4.shape[0]
    io = jnp.arange(n, dtype=jnp.int32)
    if n_valid is None:
        valid = jnp.ones((n,), bool)
        last_pos = n - 1
    else:
        valid = io < n_valid
        last_pos = n_valid - 1
    if contains_last is not None:
        last_pos = jnp.where(contains_last, last_pos, -1)

    # -- stage 1: previous pixel (the px_prev carry is just a shift).
    # Pixels compare as ONE packed u32 each (pack_rgba is needed for the
    # table anyway); the per-byte diffs for classification come from a
    # SWAR subtract on the packed lanes — no (N, 3) int8 family, no
    # narrow-int op chains.
    if prev_in is None:
        prev_in = _SEED
    packed = table.pack_rgba(px4)
    prev32 = jnp.concatenate(
        [table.pack_rgba(prev_in.astype(jnp.uint8))[None], packed[:-1]])
    eq = (packed == prev32) | ~valid

    # -- stage 2: run segmentation
    runs = scans.run_segmentation(eq, last_pos=last_pos, run_in=run_in)
    runs = runs._replace(emits_run=runs.emits_run & valid)

    # -- stage 3: color-table replay (only literal pixels write: qoi.h:415-436)
    keys = table.hash64(px4)
    hit0, (tbl_out, wr_out) = table.table_hit(
        keys, packed, write=~eq, incoming=table_in, block=table_block)
    hit = ~eq & hit0

    # -- stage 4: op classification, SWAR on the packed u32 lanes (every
    # array here is (N,) int32/uint32 — no (N, 3) int8 family, no
    # 8/16-bit op chains; range tests use the mod-256 identity
    # v in [-k, m) <=> (v + k) mod 256 < k + m)
    d32s = _swar_sub(packed, prev32)          # per-byte mod-256 diffs
    alpha_same = (d32s >> 24) == 0
    t2 = _swar_add(d32s, jnp.uint32(0x00020202))  # (dr+2, dg+2, db+2)
    is_diff = alpha_same & ((t2 & 0x00FCFCFC) == 0)
    vr8 = (d32s & 0xFF).astype(jnp.int32)
    vg8 = ((d32s >> 8) & 0xFF).astype(jnp.int32)
    vb8 = ((d32s >> 16) & 0xFF).astype(jnp.int32)
    g32 = (vg8 + 32) & 0xFF                   # (vg + 32) mod 256
    gr16 = (vr8 - vg8 + 8) & 0xFF             # (vg_r + 8) mod 256
    gb16 = (vb8 - vg8 + 8) & 0xFF             # (vg_b + 8) mod 256
    is_luma = (alpha_same & ~is_diff
               & (g32 < 64) & (gr16 < 16) & (gb16 < 16))
    is_rgb = alpha_same & ~is_diff & ~is_luma

    t2i = t2.astype(jnp.int32)
    diff_b0 = (fmt.OP_DIFF | (t2i & 3) << 4 | ((t2i >> 8) & 3) << 2
               | ((t2i >> 16) & 3))           # int32; cast per form below
    luma_b0 = fmt.OP_LUMA | g32               # g32 < 64 wherever used
    luma_b1 = (gr16 << 4) | gb16              # both < 16 wherever used
    idx_byte = (fmt.OP_INDEX | keys).astype(jnp.uint8)

    run_byte = (fmt.OP_RUN | (runs.run_val - 1)).astype(jnp.uint8)
    flush_byte = (fmt.OP_RUN | (runs.flush_val - 1)).astype(jnp.uint8)
    fl = runs.flush
    own_len = jnp.where(hit | is_diff, 1,
               jnp.where(is_luma, 2, jnp.where(is_rgb, 4, 5)))
    lens = jnp.where(
        eq,
        jnp.where(runs.emits_run, 1, 0),
        own_len.astype(jnp.int32) + fl.astype(jnp.int32),
    )

    if form == "words":
        # per-class whole-record words (bytes at/past len already zero);
        # the flush prefix and the run byte apply as word-level shifts —
        # exactly ops/compact._record_words' (lo, hi) layout without
        # ever materializing the (6, N) byte planes
        u32 = lambda v: v.astype(jnp.uint32)
        rgbx = (packed << 8) & jnp.uint32(0xFFFFFF00)  # r<<8|g<<16|b<<24
        own_lo = jnp.where(hit, u32(idx_byte),
                 jnp.where(is_diff, u32(diff_b0),
                 jnp.where(is_luma, u32(luma_b0) | u32(luma_b1) << 8,
                 jnp.where(is_rgb, fmt.OP_RGB | rgbx, fmt.OP_RGBA | rgbx))))
        own_hi = jnp.where(is_rgb | hit | is_diff | is_luma,
                           jnp.uint32(0), packed >> 24)
        lo = jnp.where(fl, u32(flush_byte) | own_lo << 8, own_lo)
        hi = jnp.where(fl, (own_lo >> 24) | own_hi << 8, own_hi)
        lo = jnp.where(eq, jnp.where(runs.emits_run, u32(run_byte), 0), lo)
        hi = jnp.where(eq, 0, hi)
        staging = (lo, hi)
    else:
        u8 = lambda x: jnp.full_like(idx_byte, x)
        own0 = jnp.where(hit, idx_byte,
                jnp.where(is_diff, diff_b0.astype(jnp.uint8),
                jnp.where(is_luma, luma_b0.astype(jnp.uint8),
                jnp.where(is_rgb, u8(fmt.OP_RGB), u8(fmt.OP_RGBA)))))
        lit1 = jnp.where(is_luma, luma_b1.astype(jnp.uint8), px4[:, 0])
        own1 = jnp.where(hit | is_diff, 0, lit1)
        own2 = jnp.where(hit | is_diff | is_luma, 0, px4[:, 1])
        own3 = jnp.where(hit | is_diff | is_luma, 0, px4[:, 2])
        own4 = jnp.where(is_rgb | hit | is_diff | is_luma, 0, px4[:, 3])

        # byte 0: RUN for run members, flush byte when pending, else the
        # chunk head; bytes 1..5 shift right one slot when a flush leads
        s0 = jnp.where(eq, run_byte, jnp.where(fl, flush_byte, own0))
        s1 = jnp.where(eq, 0, jnp.where(fl, own0, own1))
        s2 = jnp.where(eq, 0, jnp.where(fl, own1, own2))
        s3 = jnp.where(eq, 0, jnp.where(fl, own2, own3))
        s4 = jnp.where(eq, 0, jnp.where(fl, own3, own4))
        s5 = jnp.where(eq | ~fl, 0, own4)
        staging = jnp.stack([s0, s1, s2, s3, s4, s5], axis=0)  # (6, N)

    # -- outgoing carry at the valid-region boundary (for tile chaining).
    # Pads are forced eq, so last_noneq always lands inside the valid region.
    last_noneq = scans.last_true_index(~eq)[..., -1]
    n_val = last_pos + 1 if n_valid is None else n_valid
    run_in_v = jnp.int32(0) if run_in is None else jnp.asarray(run_in, jnp.int32)
    trail = jnp.where(last_noneq < 0,
                      n_val + run_in_v,          # one run since the tile start
                      (n_val - 1) - last_noneq)  # run began inside the tile
    run_out = trail % fmt.RUN_CAP
    if contains_last is not None:
        run_out = jnp.where(contains_last, 0, run_out)
    last_px = jnp.where(jnp.asarray(n_val) > 0,
                        px4[jnp.maximum(jnp.asarray(n_val) - 1, 0)], prev_in)
    carry = EncoderCarry(last_px, run_out, tbl_out, wr_out)
    if form == "words":
        return EncodedWords(staging[0], staging[1], lens, carry)
    return EncodedChunks(staging, lens, carry)


@functools.partial(jax.jit, static_argnames=("seg", "table_block"))
def encode_device_wordsum(px4: jnp.ndarray, n_valid: jnp.ndarray,
                          seg: int = 20480,
                          table_block: int = table._BLOCK):
    """Device-resident encode as ONE fused program: word-form staging
    (form='words' — the classifier emits packed record words directly,
    no (6, N) byte-plane materialization) + the word-sum compaction
    (ops/compact — sort-free, gather-free placement). `seg` is the
    compaction's segment width in pixels: longer segments mean more
    slide passes over each row, shorter ones more rows for the
    assemble's scatter. Ragged n pads with l=0 records (ops/compact).
    Returns (words (6*N//4,) uint32 — the stream bytes little-endian,
    numpy .view(uint8) on the host is free — and total int32)."""
    with profiling.annotate("qoi.encode.stage_words"):
        ch = encode_stage_chunks(px4, n_valid, form="words",
                                 table_block=table_block)
    with profiling.annotate("qoi.encode.compact"):
        return compact.compact_words6_wordsum(
            ch.lo, ch.hi, ch.lens, px4.shape[0] * 6, seg=seg,
            words_out=True)


def bucket_size(n: int, floor: int = 256) -> int:
    """Round a pixel count up to the next power of two (>= floor), bounding
    the number of distinct compiled shapes to O(log N_max)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def force_rgba(pixels: np.ndarray, desc: fmt.StreamDesc) -> np.ndarray:
    """Flatten to (N, 4) uint8, forcing alpha=255 for 3-channel input."""
    flat = np.asarray(pixels, dtype=np.uint8).reshape(-1, desc.channels)
    if flat.shape[0] != desc.num_pixels:
        raise ValueError(
            f"pixel count {flat.shape[0]} != {desc.num_pixels} from descriptor")
    if desc.channels == 3:
        flat = np.concatenate(
            [flat, np.full((flat.shape[0], 1), 255, np.uint8)], axis=1)
    return flat


def encode(pixels: np.ndarray, desc: fmt.StreamDesc, config=None) -> bytes:
    """Encode one image through the parallel pipeline; byte-identical to the
    reference encoder (qoi.h:356). `config` (an EngineConfig) tunes the
    shape-bucketing floor and the table-replay block width.

    Uses the flagship fused word-sum program (what bench.py times) and
    fetches only the stream's words, not the full 6n-byte capacity."""
    from ..utils import fetch

    desc.validate()
    px4 = force_rgba(pixels, desc)
    n = px4.shape[0]
    floor = config.bucket_floor if config else 256
    tb = config.table_block if config else table._BLOCK
    padded = np.zeros((bucket_size(n, floor), 4), np.uint8)
    padded[:n] = px4
    words, total = encode_device_wordsum(
        jnp.asarray(padded), jnp.int32(n), table_block=tb)
    total = int(jax.device_get(total))
    body = fetch.fetch_prefix(words, -(-total // 4)).view(np.uint8)[:total]
    return fmt.pack_header(desc) + body.tobytes() + fmt.TRAILER
