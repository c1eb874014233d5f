"""Color-index-table replay as a blocked last-writer-wins query.

The key insight (SURVEY.md §2.2 derived property): after any non-run pixel p
the reference table satisfies index[hash(p)] == p, whether the op was a hit
or a miss (store-on-miss, qoi.h:436; hit means the slot already held the
value). So the table state before pixel i at slot s is simply the value of
the *most recent preceding non-run pixel hashing to s* (or the zero entry) —
independent of which ops the encoder chose.

That reduces table replay to "last same-slot writer before me", computed in
three dense log-depth stages, with no gathers or scatters on the encode
side:

  1. within-block: brute-force masked max over (nb, B, B) int8 relative
     positions — all-to-all inside a 64-position block is cheaper than any
     clever structure at this size;
  2. block summaries -> exclusive cross-block `cummax` over (nb, 64) global
     writer positions (the same overwrite monoid exchanged across tiles /
     devices in strict mode, SURVEY §5.7);
  3. per-position combine + one value gather.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import format as fmt

_SLOTS = 64
_BLOCK = 64  # within-block brute-force width; must stay <= 127 for int8 iota


def pack_rgba(px4: jnp.ndarray) -> jnp.ndarray:
    """Pack (..., 4) uint8 into (...,) uint32: r | g<<8 | b<<16 | a<<24.
    Note packed(0,0,0,0) == 0 == the zero-initialised table entry, so the
    zero table needs no special-casing (SURVEY §2.2)."""
    x = px4.astype(jnp.uint32)
    return x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24


def hash64(px4: jnp.ndarray) -> jnp.ndarray:
    """Table slot (reference qoi.h:92-94). px4: (..., 4) uint8 -> int32.

    Four integer multiplies and three adds, never a dot: the sum reaches
    255 * 26 = 6630 (13 bits), beyond what a TF32 tensor-core product
    keeps exactly, and elementwise integer ops are untouched by any
    matmul precision setting."""
    return fmt.hash_px(px4.astype(jnp.int32)) & (_SLOTS - 1)


#: blocks per lax.map segment in the big-tensor phases: bounds live device
#: memory to ~seg_blocks*block^2 bytes per mask family (the all-at-once
#: form needs ~2 GB per family at 4K)
_SEG_BLOCKS = 2048


def _to_segments(keys, vals, write, query_keys, b, nb, pad):
    ns = -(-nb // _SEG_BLOCKS)
    bpad = ns * _SEG_BLOCKS - nb
    total_pad = pad + bpad * b

    def shape(x, dtype=None):
        x = jnp.pad(x, (0, total_pad))
        if dtype is not None:
            x = x.astype(dtype)
        return x.reshape(ns, _SEG_BLOCKS, b)

    return (ns, shape(keys, jnp.int8), shape(write),
            shape(vals.astype(jnp.uint32)),
            None if query_keys is None else shape(query_keys, jnp.int8))


def table_hit_local(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    write: jnp.ndarray,
    block: int = _BLOCK,
):
    """Phase A of `table_hit`: the big tensor families (in-block
    brute-force masks + per-slot value-plane summaries), processed as a
    `lax.map` over segments of blocks — bounded live memory and a small
    compile graph.

    Returns (hit_in, has_local (N,) bool; s_written (nb, 64) bool,
    s_val (nb, 64) int32 bit-pattern of the last written value).

    Round-4 form: the old wrl/svl pair of max families fuses into ONE
    packed max (last-writer position in the high bits, value-equality in
    bit 0 — the LSB of the argmax IS the hit), and the per-slot summary
    VALUE comes from an int8 argmax + one one-hot int32 masked sum
    instead of two (pos<<16 | half) i32 max families — one full-width
    plane replaces the hi/lo split everywhere downstream.
    """
    n = keys.shape[0]
    b = block
    nb = -(-n // b)
    pad = nb * b - n
    ns, k_s, w_s, v_s, _ = _to_segments(keys, vals, write, None, b, nb, pad)
    slots8 = jnp.arange(_SLOTS, dtype=jnp.int8)

    def seg(args):
        k_b, w_b, v_b = args  # (sb, b) each
        sb = k_b.shape[0]
        v_i = v_b.view(jnp.int32)
        ii = jax.lax.broadcasted_iota(jnp.int8, (sb, b, b), 1)
        jj = jax.lax.broadcasted_iota(jnp.int8, (sb, b, b), 2)
        mask = (k_b[:, :, None] == k_b[:, None, :]) & (ii > jj) & w_b[:, None, :]
        # last same-slot writer and its value-equality in ONE max: the
        # position rides in bits 1.. (unique per j, so no ties) and the
        # equality bit rides in bit 0 — LSB of the max = hit
        eqv = (v_b[:, :, None] == v_b[:, None, :]).astype(jnp.int32)
        jj32 = jax.lax.broadcasted_iota(jnp.int32, (sb, b, b), 2)
        hmax = jnp.max(jnp.where(mask, (jj32 << 1) | eqv, -1), axis=2)
        smask = (k_b[:, None, :] == slots8[None, :, None]) & w_b[:, None, :]
        sj8 = jax.lax.broadcasted_iota(jnp.int8, (sb, _SLOTS, b), 2)
        spos = jnp.max(jnp.where(smask, sj8, jnp.int8(-1)), axis=2)
        # value of the last writer: one-hot at the argmax position (spos
        # is a valid writer position whenever >= 0; sj8 never equals -1,
        # so never-written slots sum to 0 and are masked by spos >= 0)
        onehot = sj8 == spos[:, :, None]
        sval = jnp.sum(jnp.where(onehot, v_i[:, None, :], 0), axis=2)
        return (hmax >= 0) & ((hmax & 1) != 0), hmax >= 0, spos >= 0, sval

    hit_in, has_local, s_written, s_val = jax.lax.map(seg, (k_s, w_s, v_s))
    hit_in = hit_in.reshape(-1)[:n]
    has_local = has_local.reshape(-1)[:n]
    s_written = s_written.reshape(-1, _SLOTS)[:nb]
    s_val = s_val.reshape(-1, _SLOTS)[:nb]
    return hit_in, has_local, s_written, s_val


def _onehot_select_chunked(k_b, plane1, plane2):
    """Per-position select of per-(block, slot) planes by each position's
    slot, as a masked sum over the 64 slots — lax.map-chunked so the
    (blocks, b, 64) intermediates stay ~MB-sized. k_b: (nb, b) int8;
    planes: (nb, 64) int32. Returns two (nb, b) int32."""
    nb, b = k_b.shape
    ns = -(-nb // _SEG_BLOCKS)
    bpad = ns * _SEG_BLOCKS - nb
    k_p = jnp.pad(k_b, ((0, bpad), (0, 0))).reshape(ns, _SEG_BLOCKS, b)
    p1 = jnp.pad(plane1, ((0, bpad), (0, 0))).reshape(ns, _SEG_BLOCKS, _SLOTS)
    p2 = jnp.pad(plane2, ((0, bpad), (0, 0))).reshape(ns, _SEG_BLOCKS, _SLOTS)
    slots8 = jnp.arange(_SLOTS, dtype=jnp.int8)

    def seg(args):
        k, q1, q2 = args
        onehot = k[:, :, None] == slots8[None, None, :]
        s1 = jnp.sum(jnp.where(onehot, q1[:, None, :], 0), axis=2)
        s2 = jnp.sum(jnp.where(onehot, q2[:, None, :], 0), axis=2)
        return s1, s2

    s1, s2 = jax.lax.map(seg, (k_p, p1, p2))
    return (s1.reshape(-1, b)[:nb], s2.reshape(-1, b)[:nb])


def _onehot_select1_chunked(k_b, plane):
    """Single-plane variant of `_onehot_select_chunked` (the table-hit
    carry needs only the value plane — see the zero-table identity in
    `table_hit_carry`). k_b: (nb, b) int8; plane: (nb, 64) int32.
    Returns (nb, b) int32."""
    nb, b = k_b.shape
    ns = -(-nb // _SEG_BLOCKS)
    bpad = ns * _SEG_BLOCKS - nb
    k_p = jnp.pad(k_b, ((0, bpad), (0, 0))).reshape(ns, _SEG_BLOCKS, b)
    p1 = jnp.pad(plane, ((0, bpad), (0, 0))).reshape(ns, _SEG_BLOCKS, _SLOTS)
    slots8 = jnp.arange(_SLOTS, dtype=jnp.int8)

    def seg(args):
        k, q1 = args
        onehot = k[:, :, None] == slots8[None, None, :]
        return jnp.sum(jnp.where(onehot, q1[:, None, :], 0), axis=2)

    return jax.lax.map(seg, (k_p, p1)).reshape(-1, b)[:nb]


def table_hit_carry(
    local,
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    block: int = _BLOCK,
    incoming: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Phase B of `table_hit`: cross-block overwrite scan + per-position
    carry selection + hit combination. `local` = table_hit_local output."""
    hit_in, has_local, s_written, s_val = local
    n = keys.shape[0]
    b = block
    nb = -(-n // b)
    pad = nb * b - n
    k_b = jnp.pad(keys, (0, pad)).reshape(nb, b).astype(jnp.int8)
    v_b = jnp.pad(vals.astype(jnp.uint32), (0, pad)).reshape(nb, b)

    # -- cross-block overwrite scan (incoming state as a virtual block 0).
    # A flat associative_scan here is ~2*log2(nb) full passes over the
    # (nb, 64) planes; blocked_scan makes it ONE sequential pass (lanes =
    # block-columns).
    if incoming is None:
        inc_t = jnp.zeros((_SLOTS,), jnp.uint32)
        inc_w = jnp.zeros((_SLOTS,), bool)
    else:
        inc_t = incoming[0].astype(jnp.uint32)
        inc_w = incoming[1]
    # unwritten incoming slots must carry value 0 (the zero-table
    # identity below relies on it; callers may pass garbage there)
    inc_v = jnp.where(inc_w, inc_t.view(jnp.int32), 0)
    ext_w = jnp.concatenate([inc_w[None], s_written]).T          # (64, nb+1)
    ext_v = jnp.concatenate([inc_v[None], s_val]).T

    def combine(a, bb):
        aw, av = a
        bw, bv = bb
        return (aw | bw, jnp.where(bw, bv, av))

    from .scans import blocked_scan

    sc_w, sc_v = blocked_scan(combine, (ext_w, ext_v))
    # state BEFORE block i = scanned[i] (scanned[0] == incoming)
    c_v = sc_v[:, :-1].T                                         # (nb, 64)

    # -- exact one-hot select per position: multiply-free masked sum over
    # the 64 slots (one nonzero per row; int32 exact), chunked by lax.map.
    # ONE plane suffices for the hit test: a never-written slot selects 0,
    # and packed(0,0,0,0) == 0 == the zero table entry (pack_rgba note),
    # so `carry_val == v` is the hit condition written or not.
    carry_val = _onehot_select1_chunked(k_b, c_v).view(jnp.uint32)

    hit_carry = (carry_val == v_b).reshape(-1)[:n]
    hit = jnp.where(has_local, hit_in, hit_carry)

    final_written = sc_w[:, -1]
    final_table = jnp.where(final_written, sc_v[:, -1].view(jnp.uint32), 0)
    return hit, (final_table, final_written)


def table_hit(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    write: jnp.ndarray,
    block: int = _BLOCK,
    incoming: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Encoder-specialized table replay: INDEX-hit detection with ZERO
    gathers/scatters.

    hit[i] == (table value at keys[i] just before i) == vals[i], under the
    same last-writer-wins semantics as `table_replay`. See
    table_hit_local/table_hit_carry for the machinery.

    Returns (hit (N,) bool, (final_table (64,) uint32, final_written)).
    """
    local = table_hit_local(keys, vals, write, block)
    return table_hit_carry(local, keys, vals, block, incoming)


def table_select_local(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    write: jnp.ndarray,
    query_keys: jnp.ndarray,
    block: int = _BLOCK,
):
    """Phase A of `table_select`: in-block before-values per position plus
    per-slot value summaries — all big tensor families, zero gathers.

    Returns (in_hi, in_lo (N,) int32 [-1 = no in-block writer];
             s_written/s_hi/s_lo (nb, 64))."""
    n = keys.shape[0]
    b = block
    nb = -(-n // b)
    pad = nb * b - n
    ns, k_s, w_s, v_s, qk_s = _to_segments(
        keys, vals, write, query_keys, b, nb, pad)
    slots8 = jnp.arange(_SLOTS, dtype=jnp.int8)

    def seg(args):
        k_b, w_b, v_b, qk_b = args
        sb = k_b.shape[0]
        v_hi = (v_b >> 16).astype(jnp.int32)
        v_lo = (v_b & 0xFFFF).astype(jnp.int32)
        ii = jax.lax.broadcasted_iota(jnp.int8, (sb, b, b), 1)
        jj = jax.lax.broadcasted_iota(jnp.int8, (sb, b, b), 2)
        jj32 = jax.lax.broadcasted_iota(jnp.int32, (sb, b, b), 2)
        mask = (qk_b[:, :, None] == k_b[:, None, :]) & (ii > jj) & w_b[:, None, :]
        # position in bits 16.. selects the LAST in-block writer of the
        # queried slot; its value plane rides in bits 0..15 (no gather)
        in_hi = jnp.max(jnp.where(mask, (jj32 << 16) | v_hi[:, None, :], -1), axis=2)
        in_lo = jnp.max(jnp.where(mask, (jj32 << 16) | v_lo[:, None, :], -1), axis=2)
        smask = (k_b[:, None, :] == slots8[None, :, None]) & w_b[:, None, :]
        sj32 = jax.lax.broadcasted_iota(jnp.int32, (sb, _SLOTS, b), 2)
        comb_hi = jnp.max(jnp.where(smask, (sj32 << 16) | v_hi[:, None, :], -1), axis=2)
        comb_lo = jnp.max(jnp.where(smask, (sj32 << 16) | v_lo[:, None, :], -1), axis=2)
        return in_hi, in_lo, comb_hi, comb_lo

    in_hi, in_lo, comb_hi, comb_lo = jax.lax.map(seg, (k_s, w_s, v_s, qk_s))
    in_hi = in_hi.reshape(-1)[:n]
    in_lo = in_lo.reshape(-1)[:n]
    comb_hi = comb_hi.reshape(-1, _SLOTS)[:nb]
    comb_lo = comb_lo.reshape(-1, _SLOTS)[:nb]
    return (in_hi, in_lo, comb_hi >= 0, comb_hi & 0xFFFF, comb_lo & 0xFFFF)


def table_select_carry(
    local,
    query_keys: jnp.ndarray,
    block: int = _BLOCK,
    incoming: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Phase B of `table_select`: cross-block carry + per-position combine.

    Returns (before (N,) uint32, found (N,) bool, (final_table, written)):
    the table VALUE at query_keys[i] just before position i — the
    gather-free counterpart of `table_replay`'s `before`."""
    in_hi, in_lo, s_written, s_hi, s_lo = local
    n = query_keys.shape[0]
    b = block
    nb = -(-n // b)
    pad = nb * b - n
    qk_b = jnp.pad(query_keys, (0, pad)).reshape(nb, b).astype(jnp.int8)
    slots8 = jnp.arange(_SLOTS, dtype=jnp.int8)

    if incoming is None:
        inc_t = jnp.zeros((_SLOTS,), jnp.uint32)
        inc_w = jnp.zeros((_SLOTS,), bool)
    else:
        inc_t = incoming[0].astype(jnp.uint32)
        inc_w = incoming[1]
    ext_w = jnp.concatenate([inc_w[None], s_written])
    ext_hi = jnp.concatenate([(inc_t >> 16).astype(jnp.int32)[None], s_hi])
    ext_lo = jnp.concatenate([(inc_t & 0xFFFF).astype(jnp.int32)[None], s_lo])

    def combine(a, bb):
        aw, ah, al = a
        bw, bh, bl = bb
        return (aw | bw, jnp.where(bw, bh, ah), jnp.where(bw, bl, al))

    sc_w, sc_hi, sc_lo = jax.lax.associative_scan(
        combine, (ext_w, ext_hi, ext_lo), axis=0)
    c_w, c_hi, c_lo = sc_w[:-1], sc_hi[:-1], sc_lo[:-1]

    plane1 = c_w.astype(jnp.int32) * 65536 + c_hi
    plane2 = c_lo
    sel1, sel2 = _onehot_select_chunked(qk_b, plane1, plane2)
    carry_written = (sel1 >= 65536).reshape(-1)[:n]
    carry_val = (((sel1 & 0xFFFF).astype(jnp.uint32) << 16)
                 | sel2.astype(jnp.uint32)).reshape(-1)[:n]

    has_in = in_hi >= 0
    in_val = ((in_hi & 0xFFFF).astype(jnp.uint32) << 16) | (in_lo & 0xFFFF).astype(jnp.uint32)
    before = jnp.where(has_in, in_val, jnp.where(carry_written, carry_val, 0))
    found = has_in | carry_written

    final_written = sc_w[-1]
    final_table = jnp.where(
        final_written,
        (sc_hi[-1].astype(jnp.uint32) << 16) | sc_lo[-1].astype(jnp.uint32), 0)
    return before, found, (final_table, final_written)


def table_replay(
    keys: jnp.ndarray,
    vals: jnp.ndarray,
    write: jnp.ndarray,
    block: int = _BLOCK,
    incoming: Tuple[jnp.ndarray, jnp.ndarray] | None = None,
    query_keys: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Per-position table lookups under last-writer-wins replay.

    Args:
      keys: (N,) int32 slot per position (0..63) — the slot WRITTEN.
      vals: (N,) uint32 packed pixel per position.
      write: (N,) bool — whether this position writes its slot (non-run
        pixels in the encoder; every chunk in the decoder).
      block: within-block brute-force width (<= 127).
      incoming: optional initial table state (table (64,) uint32,
        written (64,) bool) — carried across tiles in strict mode.
      query_keys: optional (N,) int32 slot QUERIED by each position
        (defaults to `keys`). The decode-side INDEX resolution reads slot
        b1 while writing slot hash(px) (reference qoi.h:559 vs qoi.h:577);
        they coincide only in canonical streams.

    Returns:
      before: (N,) uint32 — table value at query_keys[i] just before
        position i (0 for never-written slots: the zero table).
      (final_table, final_written): (64,) uint32 / bool state after all
        positions, for chaining across tiles via collectives (SURVEY §5.7).
    """
    n = keys.shape[0]
    b = block
    nb = -(-n // b)
    pad = nb * b - n
    if query_keys is None:
        query_keys = keys

    k_b = jnp.pad(keys, (0, pad)).reshape(nb, b).astype(jnp.int8)
    qk_b = jnp.pad(query_keys, (0, pad)).reshape(nb, b).astype(jnp.int8)
    w_b = jnp.pad(write, (0, pad)).reshape(nb, b)

    # -- stage 1: within-block last same-slot writer, relative position
    ii = jax.lax.broadcasted_iota(jnp.int8, (nb, b, b), 1)
    jj = jax.lax.broadcasted_iota(jnp.int8, (nb, b, b), 2)
    mask = (qk_b[:, :, None] == k_b[:, None, :]) & (ii > jj) & w_b[:, None, :]
    within_rel = jnp.max(jnp.where(mask, jj, jnp.int8(-1)), axis=2)  # (nb, b)

    # -- stage 2: per-block last writer per slot -> exclusive cross-block max
    slots = jnp.arange(_SLOTS, dtype=jnp.int8)
    smask = (k_b[:, None, :] == slots[None, :, None]) & w_b[:, None, :]
    sj = jax.lax.broadcasted_iota(jnp.int8, (nb, _SLOTS, b), 2)
    summ_rel = jnp.max(jnp.where(smask, sj, jnp.int8(-1)), axis=2)  # (nb, 64)
    base = jnp.arange(nb, dtype=jnp.int32)[:, None] * b
    summ_gid = jnp.where(summ_rel >= 0, base + summ_rel, -1)
    carry_incl = jax.lax.cummax(summ_gid, axis=0)
    carry_excl = jnp.concatenate(
        [jnp.full((1, _SLOTS), -1, jnp.int32), carry_incl[:-1]], axis=0)

    # -- stage 3: combine + gather values
    carry_pos = jnp.take_along_axis(
        carry_excl, qk_b.astype(jnp.int32), axis=1)  # (nb, b)
    within_gid = jnp.where(within_rel >= 0, base + within_rel.astype(jnp.int32), -1)
    idx = jnp.maximum(carry_pos, within_gid).reshape(-1)[:n]  # -1 = no writer

    vals_ext = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), vals.astype(jnp.uint32)])
    before = vals_ext[idx + 1]

    final_idx = carry_incl[-1]  # (64,)
    final_table = vals_ext[jnp.clip(final_idx, -1, n - 1) + 1]
    final_written = final_idx >= 0

    if incoming is not None:
        inc_t, inc_w = incoming
        inc_t = inc_t.astype(jnp.uint32)
        qk = query_keys
        before = jnp.where((idx < 0) & inc_w[qk], inc_t[qk], before)
        final_table = jnp.where(final_written, final_table,
                                jnp.where(inc_w, inc_t, 0))
        final_written = final_written | inc_w

    return before, (final_table, final_written)
