"""Variable-length byte-record compaction (SURVEY.md §7.2 stage 5).

Each pixel yields 0..6 stream bytes; compaction packs them contiguously at
exclusive-prefix-sum offsets. The production placement is the word-sum
compaction (`compact_words6_wordsum`); the others are references and the
segment sort that the sequence-parallel tiled encoder still uses:

  * `compact_bytes` — sort-based: each staged byte is keyed by its target
    stream offset (invalid bytes key past the end) and one stable
    `sort_key_val` produces the packed stream.
  * `compact_bytes_scatter` — XLA scatter baseline, kept for differential
    testing.
  * `compact_bytes_merge` — scatter-free log-depth pairwise merge via
    barrel shifts; kept as a differential reference.

All return (buffer, total_len) with identical contents in [0, total).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .scans import exclusive_cumsum


def compact_bytes(
    staging: jnp.ndarray, lens: jnp.ndarray, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sort-based compaction. staging: (N, K) uint8; lens: (N,) int32 with
    lens[i] <= K; capacity: static output size (>= total bytes)."""
    n, k = staging.shape
    offs = exclusive_cumsum(lens)
    total = offs[-1] + lens[-1] if n else jnp.int32(0)
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = col < lens[:, None]
    tgt = jnp.where(valid, offs[:, None] + col, n * k).reshape(-1)
    _, packed = jax.lax.sort_key_val(tgt, staging.reshape(-1))
    if capacity <= n * k:
        out = packed[:capacity]
    else:
        out = jnp.concatenate(
            [packed, jnp.zeros((capacity - n * k,), jnp.uint8)])
    # int32 is safe: the PIXELS_MAX guard caps worst-case streams below 2 GiB
    return out, total.astype(jnp.int32)


#: pixels per compaction segment: a per-segment sort costs ~log2(SEG*6)^2
#: bitonic stages vs log2(N*6)^2 for one global sort (~6x cheaper at 8 Mpx),
#: and segments assemble with one windowed scatter-add
_COMPACT_SEG = 4096


def compact_bytes6(
    staging6: jnp.ndarray, lens: jnp.ndarray, capacity: int,
    seg: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-tier sort compaction, channel-major layout. staging6: (K, N)
    uint8 (byte-plane-major: each plane is one contiguous row); lens: (N,)
    int32.

    Tier 1: each 4096-pixel segment sorts its staged bytes locally by
    (within-segment offset << 8 | byte) — a pixel's bytes can never leave
    its segment's output range, so local sorts are globally correct.
    Tier 2: segment rows land at their global offsets via one windowed
    scatter-add — order-safe because every invalid byte is zeroed, so
    overlapping windows only add zeros onto real bytes.
    Falls back to one global sort when N isn't segment-divisible."""
    k, n = staging6.shape
    offs = exclusive_cumsum(lens)
    total = (offs[-1] + lens[-1]).astype(jnp.int32) if n else jnp.int32(0)
    col = jnp.arange(k, dtype=jnp.int32)[:, None]

    seg = seg or _COMPACT_SEG
    if n % seg or n < seg * 2:
        tgt = jnp.where(col < lens[None, :], offs[None, :] + col, n * k).reshape(-1)
        _, packed = jax.lax.sort_key_val(tgt, staging6.reshape(-1))
    else:
        nseg = n // seg
        w = seg * k
        seg_off = offs.reshape(nseg, seg)[:, 0]
        loc_off = offs - jnp.repeat(seg_off, seg)
        key = jnp.where(col < lens[None, :], loc_off[None, :] + col, w)
        rows = ((key << 8) | staging6.astype(jnp.int32)).reshape(
            k, nseg, seg).transpose(1, 0, 2).reshape(nseg, w)
        srt = jnp.sort(rows, axis=1)
        seg_bytes = jnp.where((srt >> 8) < w, srt & 0xFF, 0).astype(jnp.uint8)
        out = jnp.zeros((n * k + w,), jnp.uint8)
        dn = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,), inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0,))
        packed = jax.lax.scatter_add(
            out, seg_off[:, None], seg_bytes, dn,
            indices_are_sorted=True, unique_indices=False,
            mode=jax.lax.GatherScatterMode.CLIP)

    if capacity <= packed.shape[0]:
        out = packed[:capacity]
    else:
        out = jnp.concatenate(
            [packed, jnp.zeros((capacity - packed.shape[0],), jnp.uint8)])
    return out, total


def compact_bytes6_wordsum(
    staging6: jnp.ndarray, lens: jnp.ndarray, capacity: int,
    seg: int = 0, radix: int = 2, words_out: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Word-sum compaction: the gather/sort-free placement primitive
    (replaces the two-tier sort on the encode hot path).

    Key identities (every output byte is owned by exactly one record):

      * A record at byte offset o with value bytes packed (lo, hi)
        contributes c0/c1/c2 to output words w0 = o>>2, w0+1, w0+2 — and
        each output word's value is exactly the SUM of contributions
        targeting it.
      * Let C[w] = the running sum of ALL contribution values to words
        <= w. Then out_word[w] = C[w] - C[w-1] (sums of disjoint-byte
        values never carry within a word; the cross-word cumsum wraps
        mod 2^32 and the difference recovers each word exactly).
      * Each word w has exactly ONE "boundary event" defining C[w]: the
        record owning the word's last byte (4w+3, or T-1 for a final
        partial word). A record spans <= 6 bytes, so it owns the last
        byte of at most two words — w0 (event value Vexc + c0) and
        w0+1 (Vexc + c0 + c1), where Vexc is the exclusive cumsum of
        record contribution sums — so TWO event slots per pixel
        suffice. A final PARTIAL word has no record owning its last
        byte; its C value is simply the grand contribution total,
        patched in directly after assembly.
      * Event destinations are strictly increasing in slot order and
        cover every word exactly once, so sliding events to their word
        positions is an injective nondecreasing stream compaction — a
        log-distance shift-slide within each segment (tier 1) plus one
        windowed row scatter-add (tier 2). The
        2-slots-per-pixel list keeps every slide distance >= 0 even
        when words locally outnumber pixels (avg > 4 B/record).

    Everything is fused elementwise work + one N-length cumsum + the
    two-plane slide over 2N slots: no sort, no gather.
    staging6: (6, N) uint8; lens: (N,) int32 in [0, 6]; capacity:
    static output byte size, multiple of 4. Returns (buffer (capacity,)
    uint8 valid in [0, total), total int32)."""
    assert capacity % 4 == 0
    ev = _wordsum_events(staging6, lens, seg)
    return _wordsum_assemble(*_wordsum_slide(*ev[:2], radix=radix), *ev[2:],
                             capacity=capacity, words_out=words_out)


def compact_words6_wordsum(
    lo: jnp.ndarray, hi: jnp.ndarray, lens: jnp.ndarray, capacity: int,
    seg: int = 0, radix: int = 2, words_out: bool = False,
    sub_rows: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Word-sum compaction from packed record words (the form='words'
    staging of pipeline.encode_stage_chunks): lo (N,) uint32 = record
    bytes 0..3 little-endian, hi (N,) uint32 = bytes 4..5, bytes at or
    past lens[i] zero. Skips the byte-plane repack entirely.

    HARD CONTRACT: capacity >= total output bytes (sum of lens). The
    assemble's scatter buffer is sized min(2n, capacity//4) + sw with
    CLIP mode and its final-partial-word patch clamps into capacity; if
    capacity is ever below the true total, overflowing windows re-base
    onto the last in-capacity words and SILENTLY corrupt bytes inside
    capacity — there is no clean truncation. Every caller
    must bound capacity at the format's worst case (5 B/px + trailer
    for chunk-partitioned pixels, 6 B/px for raw per-pixel staging).
    `sub_rows` switches to subrow-relative slide distances (fewer slide
    passes, more assemble rows)."""
    assert capacity % 4 == 0
    n = lens.shape[0]
    s_eff = seg or _COMPACT_SEG
    if n < s_eff:
        s_eff = n
    elif n % s_eff:
        # pad the record list to a segment multiple with l=0 records:
        # they contribute no bytes, no events and zero sums everywhere
        # (the events build needs no validity mask for them), so the
        # result is byte-identical. Collapsing ragged n to ONE giant
        # segment instead would cost log2(2n) full-width slide passes.
        pad = s_eff - n % s_eff
        lo = jnp.concatenate([lo, jnp.zeros((pad,), lo.dtype)])
        hi = jnp.concatenate([hi, jnp.zeros((pad,), hi.dtype)])
        lens = jnp.concatenate([lens, jnp.zeros((pad,), lens.dtype)])
    if sub_rows and (2 * s_eff) % sub_rows:
        sub_rows = 0  # tiny/ragged inputs: plain segment-wide distances
    ev = _wordsum_events_words(lo, hi, lens, s_eff, sub_rows=sub_rows)
    val, aux = _wordsum_slide(ev[0], ev[1], radix=radix, dist_cap=sub_rows)
    if sub_rows:
        val = val.reshape(val.size // sub_rows, sub_rows)
    return _wordsum_assemble(val, aux, *ev[2:],
                             capacity=capacity, words_out=words_out)


def _record_words(staging6, lens):
    """Pack each pixel's staged bytes into (lo, hi|len<<16) int32 words
    with bytes at or past len masked to zero (the staging contract covers
    only bytes < len)."""
    k, n = staging6.shape
    assert k == 6
    st = staging6.astype(jnp.uint32)
    lo = st[0] | st[1] << 8 | st[2] << 16 | st[3] << 24
    hi = st[4] | st[5] << 8
    l = lens.astype(jnp.int32)
    ls = (jnp.minimum(l, 3) << 3).astype(jnp.uint32)
    m0 = jnp.where(l >= 4, jnp.uint32(0xFFFFFFFF),
                   (jnp.uint32(1) << ls) - 1)
    m1 = jnp.where(l >= 6, jnp.uint32(0xFFFF),
                   jnp.where(l == 5, jnp.uint32(0xFF), jnp.uint32(0)))
    lo = (lo & m0).view(jnp.int32)
    hl = ((hi & m1) | l.astype(jnp.uint32) << 16).view(jnp.int32)
    return lo, hl


def _wordsum_events(staging6, lens, seg=0):
    """Phase 1 of the word-sum compaction from (6, N) byte planes: pack
    to record words, then build the event list."""
    lo, hl = _record_words(staging6, lens)
    return _wordsum_events_words(
        lo.view(jnp.uint32), (hl & 0xFFFF).view(jnp.uint32), lens, seg)


def _wordsum_events_words(lo_u, hi_u, lens, seg=0, sub_rows=0):
    """Per-record word contributions, the N-length cumsums, and the
    2-slots-per-pixel boundary-event list in (nseg, 2*seg) row form.
    Returns (val, aux, cnt, wbase, total, v_all). `sub_rows` switches
    distances/counts/bases to sub_rows-slot subrow granularity (the
    slide then needs only log2(sub_rows) passes)."""
    n = lens.shape[0]
    l = lens.astype(jnp.int32)
    # (the two N-length cumsums here cannot fuse into one (2, N) pass:
    # the contribution values need the byte offsets' shift first)
    off = exclusive_cumsum(l)
    total = (off[-1] + l[-1]).astype(jnp.int32) if n else jnp.int32(0)

    s = ((off & 3) << 3).astype(jnp.uint32)
    # c1/c2 vanish automatically for records that do not cross a word
    # (lo has < 32-s live bits, hi is 0 below len 5); l=0 records have
    # zero-masked lo/hi, so the sums need no validity mask at all
    c0 = lo_u << s
    c1 = ((lo_u >> 1) >> (31 - s)) | (hi_u << s)
    c2 = (hi_u >> 1) >> (31 - s)
    vsum = c0 + c1 + c2
    vexc = exclusive_cumsum(vsum.view(jnp.int32)).view(jnp.uint32)
    v_all = vexc[-1] + vsum[-1] if n else jnp.uint32(0)

    endb = off + l
    w0 = off >> 2
    emits = l > 0
    ev0 = emits & (endb >= (w0 << 2) + 4)      # owns byte 4*w0+3
    ev1 = emits & (endb >= (w0 << 2) + 8)      # owns byte 4*(w0+1)+3
    val0 = vexc + c0
    val1 = vexc + c0 + c1

    seg = seg or _COMPACT_SEG
    if n % seg or n < seg:
        seg = n
    nseg = n // seg
    sw = 2 * seg  # slots per segment row (2 per pixel, interleaved)

    def rows2(a, b):  # (N,) x2 -> (nseg, 2*seg) in slot order p*2+k
        return jnp.stack(
            [a.reshape(nseg, seg), b.reshape(nseg, seg)],
            axis=2).reshape(nseg, sw)

    val = rows2(jnp.where(ev0, val0, 0), jnp.where(ev1, val1, 0))

    if not sub_rows:
        # flat-form distance/aux build: only val and aux ever need the
        # interleaved (nseg, 2*seg) row layout — computing d on the flat
        # (N,) k-planes drops the alive/dest interleaves (each a full
        # 2N-element shuffle) that the row-form build paid
        e0 = ev0.astype(jnp.int32)
        e1 = ev1.astype(jnp.int32)
        cnt = jnp.sum((e0 + e1).reshape(nseg, seg), axis=1)
        wbase = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                 jnp.cumsum(cnt)[:-1].astype(jnp.int32)])
        wb = jnp.broadcast_to(wbase[:, None], (nseg, seg)).reshape(-1)
        pm = jax.lax.broadcasted_iota(
            jnp.int32, (nseg, seg), 1).reshape(-1)  # slot pair base / 2
        aux0 = e0 | (jnp.where(ev0, 2 * pm - (w0 - wb), 0) << 1)
        aux1 = e1 | (jnp.where(ev1, 2 * pm + 1 - (w0 + 1 - wb), 0) << 1)
        return val, rows2(aux0, aux1), cnt, wbase, total, v_all

    alive = rows2(ev0.astype(jnp.int32), ev1.astype(jnp.int32))
    dest = rows2(w0, w0 + 1)

    if sub_rows:
        # subrow-relative distances: an event's dense target within its
        # own sub_rows-slot subrow is always <= its slot index (events
        # before it can't outnumber slots before it), so every partial
        # move stays inside the subrow and d < sub_rows by construction
        # — the slide needs only log2(sub_rows) passes (still run in the
        # wide (nseg, sw) shape). cnt/base are at
        # subrow granularity; the assemble scatter takes (nsub,
        # sub_rows) rows unchanged.
        r = sub_rows
        assert sw % r == 0
        nsub = nseg * sw // r
        a_r = alive.reshape(nsub, r)
        cnt = jnp.sum(a_r, axis=1)
        base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(cnt)[:-1].astype(jnp.int32)])
        iota_r = jax.lax.broadcasted_iota(jnp.int32, (nsub, r), 1)
        d = jnp.where(a_r != 0,
                      iota_r - (dest.reshape(nsub, r) - base[:, None]), 0)
        aux = (a_r | (d << 1)).reshape(nseg, sw)
        return val, aux, cnt, base, total, v_all


def _wordsum_slide(val, aux, radix: int = 2, dist_cap: int = 0):
    """Phase 2: slide events to their within-segment word positions by
    the digits of their distance, LSB-first — injective because
    destinations are strictly increasing; alive flag in aux bit 0,
    distance in bits 1..
    radix=4 halves the pass count (two distance bits per pass, three
    shifted candidate reads + a 4-way select)."""
    nseg, sw = val.shape
    cap = dist_cap or sw

    def shift_rows(x, j):
        j = min(j, sw)  # radix-4's 3q step can exceed the row width
        return jnp.concatenate(
            [x[:, j:], jnp.zeros((nseg, j), x.dtype)], axis=1)

    if radix == 4:
        q, lg = 1, 0
        while q < cap:
            fld = lambda a: ((a >> (1 + lg)) & 3) * (a & 1)
            here = fld(aux)
            v1, a1 = shift_rows(val, q), shift_rows(aux, q)
            v2, a2 = shift_rows(val, 2 * q), shift_rows(aux, 2 * q)
            v3, a3 = shift_rows(val, 3 * q), shift_rows(aux, 3 * q)
            in1, in2, in3 = fld(a1) == 1, fld(a2) == 2, fld(a3) == 3
            val = jnp.where(in3, v3, jnp.where(in2, v2,
                  jnp.where(in1, v1, val)))
            aux = jnp.where(in3, a3, jnp.where(in2, a2,
                  jnp.where(in1, a1, jnp.where(here != 0, 0, aux))))
            q <<= 2
            lg += 2
        return jnp.where((aux & 1) != 0, val, 0), aux

    bit = 1
    while bit < cap:
        val_s = shift_rows(val, bit)
        aux_s = shift_rows(aux, bit)
        dbit = jnp.int32(bit << 1)
        mv_in = ((aux_s & dbit) != 0) & ((aux_s & 1) != 0)
        mv_out = ((aux & dbit) != 0) & ((aux & 1) != 0)
        val = jnp.where(mv_in, val_s, val)
        aux = jnp.where(mv_in, aux_s, jnp.where(mv_out, 0, aux))
        bit <<= 1
    # alive-mask: dead slots carry stale values; masking here lets the
    # assemble skip its full-plane `iota < cnt` pass
    return jnp.where((aux & 1) != 0, val, 0), aux


def _wordsum_assemble(val, aux, cnt, wbase, total, v_all, capacity,
                      words_out: bool = False):
    """Phase 3: dense per-segment event rows -> global word offsets
    (windowed scatter-add), final-partial-word patch, cumsum difference,
    byte assembly. `words_out` skips the u32->u8 bitcast and returns
    (words (capacity//4,) uint32, total) — the stream bytes in
    little-endian word form (numpy .view(uint8) on the host is free)."""
    nseg, sw = val.shape
    n = nseg * sw // 2
    # dead slots are already zero: the slide alive-masks its output, so
    # no `iota < cnt` pass is needed here
    w_cap = capacity // 4
    if nseg == 1:
        cends = val[0]
    else:
        dn = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,), inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0,))
        # every wbase is <= total/4 <= w_cap, so a (w_cap + sw) buffer
        # always fits the windows without index clipping
        cends = jax.lax.scatter_add(
            jnp.zeros((min(2 * n, w_cap) + sw,), jnp.uint32),
            wbase[:, None], val, dn,
            indices_are_sorted=True, unique_indices=False,
            mode=jax.lax.GatherScatterMode.CLIP)
    if w_cap <= cends.shape[0]:
        cends = cends[:w_cap]
    else:
        cends = jnp.concatenate(
            [cends, jnp.zeros((w_cap - cends.shape[0],), jnp.uint32)])

    # a final partial word (total % 4 != 0) has no boundary event; its
    # cumulative value is the grand total of all contributions (for a
    # word-aligned total the last word's event already carries exactly
    # v_all, so the unconditional 1-element patch is a no-op there;
    # total == 0 clamps to index 0 whose value is 0 == v_all)
    w_last = (total - 1) >> 2
    cends = jax.lax.dynamic_update_slice(cends, v_all[None], (w_last,))

    words = cends - jnp.concatenate([jnp.zeros((1,), jnp.uint32), cends[:-1]])
    if words_out:
        return words, total
    out = jax.lax.bitcast_convert_type(
        words.view(jnp.int32), jnp.uint8).reshape(-1)
    return out, total


def compact_bytes_scatter(
    staging: jnp.ndarray, lens: jnp.ndarray, capacity: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-based compaction baseline (differential testing)."""
    n, k = staging.shape
    offs = exclusive_cumsum(lens)
    total = offs[-1] + lens[-1] if n else jnp.int32(0)
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = col < lens[:, None]
    pos = jnp.where(valid, offs[:, None] + col, capacity)  # OOB -> dropped
    out = jnp.zeros((capacity,), jnp.uint8)
    out = out.at[pos.reshape(-1)].set(staging.reshape(-1), mode="drop")
    return out, total.astype(jnp.int32)


def compact_bytes_hybrid(
    staging: jnp.ndarray, lens: jnp.ndarray, capacity: int,
    width_stop: int = 3072,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge-doubling to `width_stop`-byte records, then ONE windowed
    scatter-add assembly.

    The add is order-safe: after merging, record r's valid bytes occupy
    [off_r, off_r + len_r) and its padded tail is zero, so overlapping
    windows only ever add zeros onto real bytes. The scatter writes whole
    rows (update_window_dims), not elements.
    """
    n, k = staging.shape
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    data = jnp.where(col < lens[:, None], staging, 0)
    cur = lens.astype(jnp.int32)
    width = k

    while width < width_stop and data.shape[0] > 1:
        rows = data.shape[0]
        half = rows // 2
        first = data[0 : 2 * half : 2]
        second = data[1 : 2 * half : 2]
        len1 = cur[0 : 2 * half : 2]
        len2 = cur[1 : 2 * half : 2]
        new_width = width * 2
        first = jnp.pad(first, ((0, 0), (0, new_width - width)))
        second = jnp.pad(second, ((0, 0), (0, new_width - width)))
        second = _barrel_shift_right(second, len1, max_shift=width)
        merged = first | second
        merged_len = len1 + len2
        if rows % 2:
            tail = jnp.pad(data[-1:], ((0, 0), (0, new_width - width)))
            merged = jnp.concatenate([merged, tail], axis=0)
            merged_len = jnp.concatenate([merged_len, cur[-1:]])
        data = merged
        cur = merged_len
        width = new_width

    offs = exclusive_cumsum(cur)
    total = (offs[-1] + cur[-1]).astype(jnp.int32)
    out = jnp.zeros((capacity + width,), jnp.uint8)
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1,),
        inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0,),
    )
    out = jax.lax.scatter_add(
        out, offs[:, None], data, dnums,
        indices_are_sorted=True, unique_indices=False,
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    return out[:capacity], total


def _barrel_shift_right(x: jnp.ndarray, shift: jnp.ndarray, max_shift: int) -> jnp.ndarray:
    """Per-row right-shift of byte rows by a dynamic amount, as a composition
    of static rolls selected by the bits of `shift`. x: (R, W) uint8;
    shift: (R,) int32 in [0, max_shift]. Vacated bytes are garbage (callers
    mask); bytes shifted past W are dropped."""
    w = x.shape[-1]
    bit = 1
    while bit <= max_shift and bit < w:
        rolled = jnp.roll(x, bit, axis=-1)
        keep = jnp.arange(w, dtype=jnp.int32)[None, :] >= bit  # zero wrapped-in
        rolled = jnp.where(keep, rolled, 0)
        x = jnp.where((shift & bit)[:, None].astype(bool), rolled, x)
        bit <<= 1
    return x


def compact_bytes_merge(
    staging: jnp.ndarray, lens: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-free compaction by log-depth pairwise record merging.

    staging: (N, K) uint8 where row i holds lens[i] valid leading bytes.
    Any N; odd row counts carry their last row down unpaired. Returns
    (flat (final_width,) uint8 with the stream in [0, total), total int32).

    Every level is dense elementwise work: pairs of records concatenate via a
    barrel shift (static rolls selected by the left length's bits), so no
    gathers or scatters ever touch memory — ~constant bytes per level x
    log2(N) levels.
    """
    n, k = staging.shape
    # zero the invalid tail of every record so OR-merging is clean
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    data = jnp.where(col < lens[:, None], staging, 0)
    cur_len = lens.astype(jnp.int32)
    width = k

    while data.shape[0] > 1:
        rows = data.shape[0]
        half = rows // 2
        first = data[0 : 2 * half : 2]
        second = data[1 : 2 * half : 2]
        len1 = cur_len[0 : 2 * half : 2]
        len2 = cur_len[1 : 2 * half : 2]
        new_width = width * 2
        first = jnp.pad(first, ((0, 0), (0, new_width - width)))
        second = jnp.pad(second, ((0, 0), (0, new_width - width)))
        second = _barrel_shift_right(second, len1, max_shift=width)
        # valid regions are disjoint: [0,len1) and [len1,len1+len2)
        merged = first | second
        merged_len = len1 + len2
        if rows % 2:  # odd: the last row rides along unpaired
            tail = jnp.pad(data[-1:], ((0, 0), (0, new_width - width)))
            merged = jnp.concatenate([merged, tail], axis=0)
            merged_len = jnp.concatenate([merged_len, cur_len[-1:]])
        data = merged
        cur_len = merged_len
        width = new_width

    total = cur_len[0].astype(jnp.int32)
    return data[0], total
