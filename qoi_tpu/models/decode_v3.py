"""Blocked symbolic state-machine decoder (v3) — the default device decode path.

The reference decoder (qoi.h:488-590) is a sequential recurrence on the
state S = (px, index[64]) — 65 pixel values. The key reformulation here:
once each chunk's WRITTEN table slot w = hash-after-chunk is known, every
chunk is a static *affine-selection transform* of S:

    px' = select(op) in { px + d          (RUN d=0, DIFF, LUMA)
                        , (lit.rgb, px.a) (RGB)
                        , lit             (RGBA)
                        , S[1 + r]        (INDEX, r = b1 & 63) }
    S'[0] = px';  S'[1 + w] = px'         (the qoi.h:577 store, incl. the
                                           RUN-at-start seed store)

Such transforms compose associatively (selector composition + delta
accumulation), so the whole decode is one scan — INDEX chains of ANY
depth resolve in a single pass, unlike v2's per-hop value fixpoint.

Written slots come from the gather-free affine hash scan (hash is linear
mod 64 because 64 | 256; INDEX writes its own read slot by the table
invariant index[hash(p)] == p, reference qoi.h:577). That estimate is
exact for streams whose alpha at RGB chunks matches the last RGBA
literal and whose INDEX ops hit written slots; a device-side fixpoint
(w_{k+1} = hash(px_k)) certifies exactness and re-runs otherwise — the
same certificate as v1/v2, but the resolve inside each round is exact
given w, so canonical 3-channel streams converge in ONE round.

Execution (all gather-free except one packed u32 gather in run
expansion):

  pass 1  vmapped lax.scan over position-in-block (lanes = blocks):
          per-block symbolic 65-entry map, per-channel (root, delta)
          SWAR-packed in uint32 (root 0 = entry px, 1+s = entry slot s,
          65 = absolute)
  pass 2  associative compose of block maps + application to the seed
          state -> numeric 65-entry state at every block boundary
  pass 3  numeric re-scan emits the exact px after every chunk
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..ops import expand, fsm, scans
from ..utils import profiling
from . import decode_pipeline as v1

_SEED = jnp.array(fmt.SEED_PIXEL, dtype=jnp.uint8)
_SEED32 = np.uint32(
    fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
    | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24)
_SEED_HASH = fmt.hash_rgba(*fmt.SEED_PIXEL)
_ABS = 65  # per-channel root symbol: absolute value (no entry dependence)
_MAX_ROUNDS = 12

# op classes (cls field): 0 identity (non-chunk byte), 1 additive
# (RUN d=0 / DIFF / LUMA), 2 RGB, 3 RGBA, 4 INDEX
_CLS_ID, _CLS_ADD, _CLS_RGB, _CLS_RGBA, _CLS_INDEX = range(5)


def _swar_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-byte mod-256 add of 4x-u8-packed uint32 lanes (no cross-byte
    carry: the masked halves keep carries in the zero gaps)."""
    m2 = jnp.uint32(0xFF00FF00)
    lo = ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF
    hi = ((a & m2) + (b & m2)) & m2
    return lo | hi


def _hash_packed(px32: jnp.ndarray) -> jnp.ndarray:
    """(3r + 5g + 7b + 11a) & 63 from packed uint32 (reference qoi.h:92)."""
    p = px32.astype(jnp.uint32)
    m = fmt.HASH_MULTIPLIERS
    h = (m[0] * (p & 0xFF) + m[1] * ((p >> 8) & 0xFF)
         + m[2] * ((p >> 16) & 0xFF) + m[3] * ((p >> 24) & 0xFF))
    return (h & 63).astype(jnp.int32)


def _shift_up(x, k):
    pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
    return jnp.concatenate([x[k:], pad], axis=0)


def _fields(data: jnp.ndarray, chunks_len: jnp.ndarray):
    """Per-byte chunk fields from shifted arrays (no gathers). data: (M,)
    uint8. Returns cls, r6, d32, lit32, npix (all (M,) int32/uint32)."""
    starts = fsm.chunk_starts(data, chunks_len)
    d1 = data.astype(jnp.int32)
    b2 = _shift_up(data, 1).astype(jnp.uint32)
    b3 = _shift_up(data, 2).astype(jnp.uint32)
    b4 = _shift_up(data, 3).astype(jnp.uint32)
    b5 = _shift_up(data, 4).astype(jnp.uint32)

    is_rgb = (d1 == fmt.OP_RGB) & starts
    is_rgba = (d1 == fmt.OP_RGBA) & starts
    two = d1 & fmt.MASK_2
    other = ~is_rgb & ~is_rgba & starts
    is_index = other & (two == fmt.OP_INDEX)
    is_diff = other & (two == fmt.OP_DIFF)
    is_luma = other & (two == fmt.OP_LUMA)
    is_run = other & (two == fmt.OP_RUN)

    cls = jnp.where(is_rgb, _CLS_RGB,
          jnp.where(is_rgba, _CLS_RGBA,
          jnp.where(is_index, _CLS_INDEX,
          jnp.where(is_diff | is_luma | is_run, _CLS_ADD, _CLS_ID))))
    r6 = jnp.where(is_index, d1 & 63, 0)
    npix = jnp.where(is_run, (d1 & 0x3F) + 1,
                     starts.astype(jnp.int32))

    # mod-256 deltas as the decoder applies them (reference qoi.h:562-572)
    dr = jnp.where(is_diff, ((d1 >> 4) & 3) - 2, 0)
    dg2 = jnp.where(is_diff, ((d1 >> 2) & 3) - 2, 0)
    db = jnp.where(is_diff, (d1 & 3) - 2, 0)
    vg = (d1 & 0x3F) - 32
    lr = vg - 8 + ((b2.astype(jnp.int32) >> 4) & 0x0F)
    lb = vg - 8 + (b2.astype(jnp.int32) & 0x0F)
    dr = jnp.where(is_luma, lr, dr) & 0xFF
    dg = jnp.where(is_luma, vg, dg2) & 0xFF
    db = jnp.where(is_luma, lb, db) & 0xFF
    d32 = (dr | dg << 8 | db << 16).astype(jnp.uint32)
    lit32 = b2 | b3 << 8 | b4 << 16 | b5 << 24
    return starts, cls, r6, d32, lit32, npix


def _initial_w(cls, r6, d32, lit32, entry_px32=None, npix=None):
    """Optimistic per-byte written-slot estimate, as ONE affine scan over
    the coupled state (alpha, hash) (v1's _initial_hashes at byte
    granularity, gather-free). The RGB reset's hash needs the running
    alpha (h' = c + 11a mod 64), so alpha and hash form a joint affine
    recurrence:

        a' = ra ? va : a                 (RGBA literal overwrites alpha)
        h' = g*h + t*a + e   (mod 64)    (g,t,e per op class, see below)

    Affine maps compose associatively; the five coefficients pack into
    one int32 ([ra:1 | g:1 | t:6 | e:6 | va:8]), so the scan moves ONE
    int32 leaf instead of the two-scan form's four (alpha overwrite scan
    + hash reset-or-add scan) — one full blocked_scan pass less. The
    estimate is exact unless an INDEX changed alpha between RGBA and RGB
    chunks (fixpoint-corrected downstream). `entry_px32` (traced u32,
    default the seed pixel) sets the incoming px for tiled/streamed
    chaining: its hash seeds h and its alpha seeds a."""
    m3, m5, m7, m11 = fmt.HASH_MULTIPLIERS
    if entry_px32 is None:
        entry_hash = jnp.int32(_SEED_HASH)
        entry_alpha = jnp.int32(fmt.SEED_PIXEL[3])
    else:
        entry_hash = _hash_packed(entry_px32[None])[0]
        entry_alpha = ((entry_px32 >> 24) & 0xFF).astype(jnp.int32)
    is_rgba = cls == _CLS_RGBA
    is_rgb = cls == _CLS_RGB
    b2 = (lit32 & 0xFF).astype(jnp.int32)
    b3 = ((lit32 >> 8) & 0xFF).astype(jnp.int32)
    b4 = ((lit32 >> 16) & 0xFF).astype(jnp.int32)
    b5 = ((lit32 >> 24) & 0xFF).astype(jnp.int32)

    # per-op coefficients: ID (1,0,0) / ADD (1,0,dh) / RGBA (0,0,habs)
    # / RGB (0,11,c) / INDEX (0,0,r6); alpha: RGBA sets ra=1, va=b5
    dh = (m3 * (d32 & 0xFF).astype(jnp.int32)
          + m5 * ((d32 >> 8) & 0xFF).astype(jnp.int32)
          + m7 * ((d32 >> 16) & 0xFF).astype(jnp.int32)) & 63
    habs = (m3 * b2 + m5 * b3 + m7 * b4 + m11 * b5) & 63
    c_rgb = (m3 * b2 + m5 * b3 + m7 * b4) & 63
    is_reset = is_rgb | is_rgba | (cls == _CLS_INDEX)
    g = (~is_reset).astype(jnp.int32)
    t = jnp.where(is_rgb, m11 & 63, 0)
    e = jnp.where(is_rgba, habs,
        jnp.where(is_rgb, c_rgb,
        jnp.where(cls == _CLS_INDEX, r6,
        jnp.where(cls == _CLS_ADD, dh, 0))))
    packed = (is_rgba.astype(jnp.int32) | (g << 1) | (t << 2) | (e << 8)
              | (jnp.where(is_rgba, b5, 0) << 14))

    def comb(p1, p2):
        ra1, g1 = p1 & 1, (p1 >> 1) & 1
        t1, e1, va1 = (p1 >> 2) & 63, (p1 >> 8) & 63, (p1 >> 14) & 0xFF
        ra2, g2 = p2 & 1, (p2 >> 1) & 1
        t2, e2, va2 = (p2 >> 2) & 63, (p2 >> 8) & 63, (p2 >> 14) & 0xFF
        g = g1 & g2
        t = (g2 * t1 + (1 - ra1) * t2) & 63
        e = (g2 * e1 + e2 + ra1 * t2 * va1) & 63
        ra = ra1 | ra2
        va = jnp.where(ra2 != 0, va2, va1)
        return ra | (g << 1) | (t << 2) | (e << 8) | (va << 14)

    if npix is None:
        ps = scans.blocked_scan(comb, packed)
    else:
        # co-scan the pixel-offset cumsum on the same blocked pass: the
        # affine leaf and the npix add share one memory traversal instead
        # of two separate full-array scans (pix_off = exclusive form)
        ps, inc = scans.blocked_scan(
            lambda a, b: (comb(a[0], b[0]), a[1] + b[1]), (packed, npix))
    gs, ts_, es = (ps >> 1) & 1, (ps >> 2) & 63, (ps >> 8) & 63
    w = (gs * entry_hash + ts_ * entry_alpha + es) & 63
    if npix is None:
        return w
    return w, inc - npix


def _anchored_w(cls, r6, d32, px32, entry_px32=None):
    """Next-round written-slot estimate from a resolve's px values,
    re-anchored at every reset chunk.

    The naive iteration w' = hash(px) inherits ALL of px's downstream
    corruption (one wrong table write poisons every INDEX read of that
    slot, so the exact prefix advances only ~1 error per round). But
    the hash
    recurrence re-anchors absolutely at three of the four op classes:

      INDEX r:  hash(px') = r by the table invariant index[hash(p)]==p
                (qoi.h:577) — exact regardless of px corruption;
      RGBA:     hash is a literal function of the chunk bytes;
      RGB:      hash(px') = hash of the resolved px' — exact wherever
                the running alpha is unpoisoned (alpha is the ONLY
                value dependence);
      ADD/RUN:  h' = h + hash(delta) mod 64 (64 | 256 makes the hash
                compatible with byte-wise mod-256 adds).

    So one affine (g, e) scan with e = r6 at INDEX, hash(px) at
    RGB/RGBA, hash(delta) at ADD rebuilds w with errors ONLY at RGB
    chunks whose resolved alpha was poisoned — every genuine
    stale-alpha error of the initial estimate is fixed in one round,
    and canonical streams of every content class converge in ~2-3
    rounds (the certificate in _decode_core stays hash(px) == w).
    Non-canonical INDEX-to-unwritten-slot streams violate the r6
    anchor's invariant and take the fallback ladder via the stall
    bail, as before."""
    if entry_px32 is None:
        entry_hash = jnp.int32(_SEED_HASH)
    else:
        entry_hash = _hash_packed(entry_px32[None])[0]
    ps = scans.blocked_scan(_anch_comb, _anch_leaf(cls, r6, d32, px32))
    return ((ps & 1) * entry_hash + (ps >> 1)) & 63


def _anch_leaf(cls, r6, d32, px32):
    """Packed (g, e) affine leaf of the anchored-w recurrence."""
    m3, m5, m7, _ = fmt.HASH_MULTIPLIERS
    dh = (m3 * (d32 & 0xFF).astype(jnp.int32)
          + m5 * ((d32 >> 8) & 0xFF).astype(jnp.int32)
          + m7 * ((d32 >> 16) & 0xFF).astype(jnp.int32)) & 63
    is_reset = (cls == _CLS_RGB) | (cls == _CLS_RGBA) | (cls == _CLS_INDEX)
    g = (~is_reset).astype(jnp.int32)
    e = jnp.where(cls == _CLS_INDEX, r6,
        jnp.where(is_reset, _hash_packed(px32),
        jnp.where(cls == _CLS_ADD, dh, 0)))
    return g | (e << 1)


def _anch_comb(p1, p2):
    g1, e1 = p1 & 1, p1 >> 1
    g2, e2 = p2 & 1, p2 >> 1
    return (g1 & g2) | (((g2 * e1 + e2) & 63) << 1)


def _anchored_w_rows(cls_g, r6_g, d32_g, px_g, entry_h):
    """`_anchored_w` over independent gathered blocks: (K, B) planes
    scanned along axis -1, one entry hash per row (the surgical round's
    narrow rebuild — same recurrence, same convergence argument)."""
    ps = scans.blocked_scan(_anch_comb,
                            _anch_leaf(cls_g, r6_g, d32_g, px_g))
    return ((ps & 1) * entry_h[:, None] + (ps >> 1)) & 63


def _step_common(rec, px_root, px_val, src_root, src_val):
    """New px entry (root, val) for one scan step. rec: (meta, d32, lit32),
    all (nb,)."""
    meta, d32, lit32 = rec
    cls = meta & 7
    addv = _swar_add(px_val, d32)
    rgbv = (lit32 & 0x00FFFFFF) | (px_val & jnp.uint32(0xFF000000))
    new_val = jnp.where(cls == _CLS_ADD, addv,
              jnp.where(cls == _CLS_RGB, rgbv,
              jnp.where(cls == _CLS_RGBA, lit32,
              jnp.where(cls == _CLS_INDEX, src_val, px_val))))
    if px_root is None:
        return None, new_val
    rgbr = (px_root & jnp.uint32(0xFF000000)) | 0x00414141  # rgb ABS, a flows
    new_root = jnp.where(cls == _CLS_ADD, px_root,
               jnp.where(cls == _CLS_RGB, rgbr,
               jnp.where(cls == _CLS_RGBA, jnp.uint32(0x41414141),
               jnp.where(cls == _CLS_INDEX, src_root, px_root))))
    return new_root, new_val


def _select_row(rows, idx, plane):
    """plane[idx[n], n] without a gather: one-hot masked sum over the
    (tiny) row axis. rows: (R, 1) iota; idx: (nb,); plane: (R, nb)."""
    sel = rows == idx[None, :]
    return jnp.sum(jnp.where(sel, plane, 0), axis=0,
                   dtype=plane.dtype)


def _block_maps(meta, d32, lit32, nb: int, b: int, emit_px: bool = False):
    """Pass 1: per-block symbolic 65-entry maps. Inputs are (B, nb)
    position-major records. Returns (root (65, nb), val (65, nb)) uint32,
    plus — when `emit_px` — the px entry's symbolic (root, val) AFTER
    every position ((B, nb) uint32 each), which lets the vectorized
    pass-3 replacement (`_apply_symbolic`) skip the numeric re-scan.

    The px entry (row 0) rides as its own (nb,) vector inside the scan —
    keeping it out of the table plane shrinks the per-step one-hot work
    to exactly 64 rows (8 full vregs) and turns the row-0 write into a
    cheap vector select."""
    rows = jnp.arange(64, dtype=jnp.int32)[:, None]  # table slots only
    px_root0 = jnp.zeros((nb,), jnp.uint32)          # root 0 = entry px
    px_val0 = jnp.zeros((nb,), jnp.uint32)
    troot0 = jnp.broadcast_to(
        ((1 + rows).astype(jnp.uint32) * jnp.uint32(0x01010101)), (64, nb))
    tval0 = jnp.zeros((64, nb), jnp.uint32)

    def step(state, rec):
        px_root, px_val, troot, tval = state
        meta_i = rec[0]
        cls = meta_i & 7
        w = (meta_i >> 3) & 63
        # ONE one-hot serves both the INDEX source select and the table
        # write: src is consumed only at INDEX ops, and an INDEX writes
        # its own read slot (w == r6 by the table invariant — both
        # _initial_w and _anchored_w anchor e = r6 there), so the slot
        # read IS the slot written; other classes ignore src entirely
        sel = rows == w[None, :]
        src_root = jnp.sum(jnp.where(sel, troot, 0), axis=0, dtype=troot.dtype)
        src_val = jnp.sum(jnp.where(sel, tval, 0), axis=0, dtype=tval.dtype)
        new_root, new_val = _step_common(
            rec, px_root, px_val, src_root, src_val)
        live = cls != _CLS_ID
        px_root = jnp.where(live, new_root, px_root)
        px_val = jnp.where(live, new_val, px_val)
        mask = sel & live[None, :]
        ys = (px_root, px_val) if emit_px else None
        return (px_root, px_val,
                jnp.where(mask, new_root[None, :], troot),
                jnp.where(mask, new_val[None, :], tval)), ys

    (px_root, px_val, troot, tval), ys = jax.lax.scan(
        step, (px_root0, px_val0, troot0, tval0), (meta, d32, lit32),
        unroll=_P1_UNROLL)
    root = jnp.concatenate([px_root[None], troot], axis=0)
    val = jnp.concatenate([px_val[None], tval], axis=0)
    if emit_px:
        return root, val, ys[0], ys[1]
    return root, val


def _compose_entry_states(root, val, nb: int, entry65=None,
                          return_exit: bool = False):
    """Pass 2: inclusive associative compose of block maps (per-channel
    one-hot lookups over the 65-entry axis), then application to the
    stream-entry state -> packed numeric 65-entry state at every block
    ENTRY. `entry65` ((65,) packed u32: px + 64 slots, default seed px
    and zeroed slots) supports tiled/streamed chaining. `return_exit`
    additionally returns the packed state after the LAST block ((65,)
    u32) — the stream's exit state, which the vectorized pass-3
    replacement needs because it no longer runs a numeric scan."""
    # unpack per channel: (4, 65, nb) int32
    shifts = jnp.array([0, 8, 16, 24], jnp.uint32)[:, None, None]
    rc = ((root[None] >> shifts) & 0xFF).astype(jnp.int32)
    vc = ((val[None] >> shifts) & 0xFF).astype(jnp.int32)
    k = jnp.arange(65, dtype=jnp.int32)

    def comb(a, bb):
        ar, av = a
        br, bv = bb
        onehot = br[:, :, None, :] == k[None, None, :, None]
        lr = jnp.sum(jnp.where(onehot, ar[:, None, :, :], 0), axis=2)
        lv = jnp.sum(jnp.where(onehot, av[:, None, :, :], 0), axis=2)
        is_abs = br == _ABS
        return (jnp.where(is_abs, _ABS, lr),
                jnp.where(is_abs, bv, (lv + bv) & 0xFF))

    # plain associative_scan: nb (block count) is M/B — tens of thousands
    # at most; the combine's (4, 65, X) layout must stay fixed (one-hot
    # over axis 2)
    rs, vs = jax.lax.associative_scan(comb, (rc, vc), axis=-1)

    # apply to the initial state (per channel (4, 65)): the composed map's
    # root r means "entry state's entry r" — a one-hot lookup into init
    if entry65 is None:
        seed_c = jnp.array(fmt.SEED_PIXEL, jnp.int32)[:, None]
        init = jnp.concatenate(
            [seed_c, jnp.zeros((4, 64), jnp.int32)], axis=1)  # (4, 65)
    else:
        sh1 = jnp.array([0, 8, 16, 24], jnp.uint32)[:, None]
        init = ((entry65[None] >> sh1) & 0xFF).astype(jnp.int32)  # (4, 65)
    looked = jnp.sum(
        jnp.where(rs[:, :, None, :] == k[None, None, :, None],
                  init[:, None, :, None], 0), axis=2)  # (4, 65, nb)
    applied = jnp.where(rs == _ABS, vs, (vs + looked) & 0xFF)
    entry = jnp.concatenate([init[:, :, None], applied[:, :, :-1]], axis=2)
    packed = (entry[0].astype(jnp.uint32)
              | entry[1].astype(jnp.uint32) << 8
              | entry[2].astype(jnp.uint32) << 16
              | entry[3].astype(jnp.uint32) << 24)
    if not return_exit:
        return packed  # (65, nb)
    exit65 = (applied[0, :, -1].astype(jnp.uint32)
              | applied[1, :, -1].astype(jnp.uint32) << 8
              | applied[2, :, -1].astype(jnp.uint32) << 16
              | applied[3, :, -1].astype(jnp.uint32) << 24)
    return packed, exit65


def _apply_symbolic(proot, pval, entry_packed):
    """Vectorized pass 3: numeric px after every position from the
    symbolic per-position px entries (pass 1's `emit_px` output) and the
    per-block entry states (pass 2). Replaces the sequential numeric
    re-scan — the scan's B sequential steps are latency-bound, while this
    form is ~65 fused SWAR select/accumulate passes over (B, nb), fully
    parallel.

    Per channel c of position i in block n:
        px_c = pval_c                          if proot_c == _ABS
             = (entry[proot_c][c] + pval_c) % 256  otherwise
    The 65-way lookup runs SWAR-packed: for each entry row k, an exact
    per-byte zero test of proot ^ (k * 0x01010101) selects that row's
    bytes (at most one k matches per byte); _ABS (= 65) matches no k, so
    its accumulator byte stays 0 and the final mod-256 add returns pval
    unchanged — the ABS case falls out with no extra select."""
    acc = jnp.zeros_like(pval)
    m7f = jnp.uint32(0x7F7F7F7F)
    for k in range(_ABS):
        x = proot ^ jnp.uint32(k * 0x01010101)
        # exact SWAR zero-byte test (no cross-byte borrow: 0x7F + 0x7F
        # cannot carry out of bit 7): bit7 of each byte of ~y is set
        # iff that byte of x is zero
        y = ((x & m7f) + m7f) | x
        # 0/1 per matching byte -> 0xFF per matching byte (0x01 * 0xFF
        # stays in-byte, no carries), then mask the entry row in
        mfull = ((~y & jnp.uint32(0x80808080)) >> 7) * jnp.uint32(0xFF)
        acc = acc | (entry_packed[k][None, :] & mfull)
    return _swar_add(acc, pval)


def _numeric_scan(meta, d32, lit32, entry, nb: int):
    """Pass 3: numeric re-scan from per-block entry states; emits the px
    value after every byte position. Returns ((B, nb) uint32 px,
    (65,) uint32 exit state = the 65-entry state after the LAST block's
    last position — padding bytes are identity, so this is the stream's
    exit state for tile chaining)."""
    rows = jnp.arange(64, dtype=jnp.int32)[:, None]  # table slots only

    def step(state, rec):
        px_val, tval = state
        meta_i = rec[0]
        cls = meta_i & 7
        w = (meta_i >> 3) & 63
        sel = rows == w[None, :]  # src slot == write slot (see _block_maps)
        src_val = jnp.sum(jnp.where(sel, tval, 0), axis=0, dtype=tval.dtype)
        _, new_val = _step_common(rec, None, px_val, None, src_val)
        live = cls != _CLS_ID
        px_val = jnp.where(live, new_val, px_val)
        mask = sel & live[None, :]
        tval = jnp.where(mask, new_val[None, :], tval)
        return (px_val, tval), px_val

    (px_f, tval_f), px = jax.lax.scan(
        step, (entry[0], entry[1:]), (meta, d32, lit32))
    exit65 = jnp.concatenate([px_f[-1:], tval_f[:, -1]])
    return px, exit65


#: cap on the resolve's scan length B: longer scans mean more
#: sequential pass-1 steps, shorter ones a wider pass-2 compose (its work
#: grows with nb = M/B). Sized for a 16 GB device; not yet re-swept for
#: larger ones.
_SCAN_B_MAX = 8192

#: pass-1 lax.scan unroll: scan steps here are not bookkeeping-bound,
#: so unrolling only makes bigger bodies to schedule.
_P1_UNROLL = 1

#: surgical second round: narrow dirty-window rebuild + exact
#: entry-delta apply between the peeled round 1 and the full-round
#: loop. A batched (vmapped) decode only profits when EVERY lane is
#: surgically fixable — one dense-error lane drags the whole batch
#: through the full round anyway, making the surgical pure overhead
#: there, so batches leave it off.
_SURGICAL = True

def _scan_block_len(m: int) -> int:
    """Static scan length B (positions per block): keeps lane width nb =
    m / B wide enough to fill the device while bounding sequential
    steps."""
    b = 16
    while b < _SCAN_B_MAX and b * 64 <= m:
        b <<= 1
    return b


def _pos_major(x, m: int, b: int):
    """(M,) -> (B, nb): position i of block k at [i, k]."""
    return x.reshape(m // b, b).T


def _resolve_p(base_p, d32_p, lit32_p, w, m: int, b: int, entry65=None,
               apply: str = "vector"):
    """One full symbolic resolve given written slots w, from
    PRE-TRANSPOSED loop-invariant planes (base_p = position-major
    cls | r6 << 9, d32_p, lit32_p). Only w — the one per-round input —
    pays a transpose per round; the other three planes transpose once
    per decode in `_decode_core` (re-transposing all of them inside
    every fixpoint round costs ~3 x 58 MB of memory round-trips per
    round at 4K).

    Returns (px32 (M,) uint32: the decoder's px value after every byte
    position, exit65). `apply` picks pass 3: "vector" (default) applies
    pass-2 entry states to pass-1's per-position symbolic px entries in
    one fused SWAR pass (`_apply_symbolic` — no second sequential scan);
    "scan" is the original numeric re-scan, the differential anchor."""
    nb = m // b
    meta_p = (base_p | (_pos_major(w, m, b) << 3)).astype(jnp.int32)
    if apply == "vector":
        root, val, proot, pval = _block_maps(
            meta_p, d32_p, lit32_p, nb, b, emit_px=True)
        entry, exit65 = _compose_entry_states(root, val, nb, entry65,
                                              return_exit=True)
        px = _apply_symbolic(proot, pval, entry)
        return px.T.reshape(m), exit65, (root, val, entry, proot)
    root, val = _block_maps(meta_p, d32_p, lit32_p, nb, b)
    entry = _compose_entry_states(root, val, nb, entry65)
    px, exit65 = _numeric_scan(meta_p, d32_p, lit32_p, entry, nb)
    return px.T.reshape(m), exit65, None


def _resolve(cls, r6, w, d32, lit32, m: int, b: int, entry65=None,
             apply: str = "vector"):
    """One full symbolic resolve given written slots w (flat-plane
    convenience wrapper around `_resolve_p`)."""
    base_p = _pos_major((cls | (r6 << 9)).astype(jnp.int32), m, b)
    px, exit65, _ = _resolve_p(base_p, _pos_major(d32, m, b),
                               _pos_major(lit32, m, b), w, m, b,
                               entry65, apply)
    return px, exit65


def _swar_sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-byte mod-256 subtract of 4x-u8-packed uint32 lanes: a guard
    bit above each byte absorbs the borrow, so (0x100 + a_b - b_b) & 0xFF
    comes out per byte with no cross-byte interference."""
    m = jnp.uint32(0x00FF00FF)
    g = jnp.uint32(0x01000100)
    lo = (((a & m) | g) - (b & m)) & m
    hi = ((((a >> 8) & m) | g) - ((b >> 8) & m)) & m
    return lo | (hi << 8)


def _decode_core(data: jnp.ndarray, chunks_len: jnp.ndarray,
                 max_rounds: int = _MAX_ROUNDS, entry65=None,
                 apply: str = "vector", surgical: bool = True):
    """Full chunk-level decode to per-byte px values + bookkeeping.
    Returns (px32 (M,) u32, starts, npix, pix_off, converged, rounds,
    exit65). `entry65` ((65,) packed u32 incoming state, default seed)
    supports streamed/tiled chaining; exit65 is the matching outgoing
    state (valid only when converged). `surgical` enables the narrow
    second round — leave OFF for vmapped batches (one dense-error lane
    drags the whole batch through the full round anyway, making the
    surgical pure overhead there)."""
    m = data.shape[0]
    b = _scan_block_len(m)
    nbk = m // b
    starts, cls, r6, d32, lit32, npix = _fields(data, chunks_len)
    entry_px32 = None if entry65 is None else entry65[0]
    w0i, pix_off = _initial_w(cls, r6, d32, lit32, entry_px32, npix=npix)
    w0 = jnp.where(starts, w0i, 0)

    # the surgical round engages only under all of these (the narrow
    # rebuild needs real narrowing; batches leave it off — see flag doc)
    use_surgical = (apply == "vector" and max_rounds > 1 and nbk >= 256
                    and surgical and _SURGICAL)

    base_f = (cls | (r6 << 9)).astype(jnp.int32)
    if use_surgical:
        # loop-invariant position-major planes, transposed ONCE (each
        # round re-transposing them costs ~3 x 58 MB of memory round-trips
        # at 4K — and the surgical body reads them anyway). NOT hoisted
        # for batched decodes: planes alive across the loop cost ~175
        # MB/lane of device memory — worth it only when the surgical
        # needs them resident.
        base_p = _pos_major(base_f, m, b)
        d32_p = _pos_major(d32, m, b)
        lit32_p = _pos_major(lit32, m, b)

        def resolve_fn(w):
            return _resolve_p(base_p, d32_p, lit32_p, w, m, b,
                              entry65, apply)
    else:
        def resolve_fn(w):
            return _resolve_p(_pos_major(base_f, m, b),
                              _pos_major(d32, m, b),
                              _pos_major(lit32, m, b), w, m, b,
                              entry65, apply)

    def round_(w, prev_bad, with_extra=False):
        px, exit65, extra = resolve_fn(w)
        # certificate: self-consistency w == hash(px(w)) forces exactness
        # (the consistent prefix is unique by induction on positions)
        true_w = jnp.where(starts, _hash_packed(px), 0)
        mis = true_w != w
        bad = jnp.sum(mis.astype(jnp.int32))
        # bail early (bad = -1 flag) when the mismatch count stops
        # shrinking: only non-canonical streams (INDEX reads of
        # unwritten slots break the r6 anchor's table invariant) stall
        # now — burning all max_rounds would just delay the fallback
        stalled = (bad > 0) & (bad >= prev_bad)
        bad = jnp.where(stalled, jnp.int32(-1), bad)
        if not with_extra:
            return px, exit65, bad
        mis_b = jnp.any(mis.reshape(nbk, b), axis=1)
        return px, exit65, bad, extra, mis_b

    # loop state is SLIM (a batched while_loop pays memory traffic per
    # carried plane — masked-lane selects touch every carry each
    # iteration): px is the one big carry, w is NOT carried (the body
    # rebuilds it from px and nothing downstream reads it)
    def body(state):
        px_prev, _, it, prev_bad, _ = state
        # next estimate: re-anchored in the previous round's px, NOT
        # true_w = hash(px) — hash(px) wholesale re-corrupts every
        # estimate downstream of the first wrong write, advancing the
        # exact prefix ~1 error per round; the anchored rebuild fixes
        # all genuine stale-alpha errors at once
        w = jnp.where(starts, _anchored_w(cls, r6, d32, px_prev,
                                          entry_px32), 0)
        px, exit65, bad = round_(w, prev_bad)
        return (px, bad == 0, it + 1, bad, exit65)

    def cond(state):
        _, conv, it, bad, _ = state
        return ~conv & (it < max_rounds) & (bad != -1)

    # round 1 is peeled so the anchored rebuild (a full blocked scan)
    # only ever executes for streams that truly need a second round —
    # constant-alpha content (the whole benchmark-suite class) has an
    # exact initial estimate and never pays it
    px1, exit1, bad1, extra1, mis_b = round_(
        w0, jnp.int32(0x7FFFFFFF), with_extra=True)
    state = (px1, bad1 == 0, jnp.int32(1), bad1, exit1)

    # the surgical round only pays when the K-block rebuild is genuinely
    # narrow (>= 4x fewer lanes than a full pass 1); tiny streams go
    # straight to the full-round loop (at nbk = 32 the "surgical" round
    # would do more work than a full round)
    if use_surgical:
        # ---- surgical round 2 -------------------------------------------
        # The full second round costs as much as the first, but its
        # genuine new information is tiny: round-1
        # certificate mismatches are sparse (stale-alpha RGB chunks) and
        # the anchored-w fix is LOCAL — w1 differs from w0 only between a
        # mismatch and the next reset chunk. So: rebuild w and the pass-1
        # block maps ONLY for the (mismatch ∪ successor) blocks, recompose
        # pass 2 over the patched maps (cheap), and get every clean
        # block's px by the exact delta identity
        #     px2 = px1 (+) (entry2 - entry1)[proot]   (per channel mod 256)
        # — for unchanged maps, px(entry) = entry[root] + val, so the
        # entry-state delta IS the px delta. Dirty blocks get a fresh
        # narrow apply. Correctness does NOT rest on any of this being a
        # good heuristic: px2 ≡ resolve(w2) algebraically, and the full
        # certificate (hash(px2) == w2 everywhere) is re-checked — on
        # failure (or > K dirty blocks) the unchanged full-round
        # while_loop below takes over, as before.
        root1, val1, entry1, proot1 = extra1
        W, WB = 8, 8                      # 8 windows x 8 blocks = 64
        K = W * WB
        dirty = mis_b | jnp.concatenate(
            [jnp.zeros((1,), bool), mis_b[:-1]])
        # greedy cover of the dirty blocks by W contiguous WB-block
        # windows: single-offset dynamic slices move contiguous memory,
        # where per-row gathers/scatters of the same volume would not.
        # Windows are disjoint by construction (the next start is past
        # the previous window).
        iot = jnp.arange(nbk, dtype=jnp.int32)
        sj = []
        prev_end = jnp.int32(-1)
        for _ in range(W):
            s = jnp.min(jnp.where(dirty & (iot > prev_end), iot, nbk))
            sj.append(s)
            prev_end = s + (WB - 1)
        sj = jnp.stack(sj)                              # (W,) starts
        win_ok = sj < nbk
        # clamp trailing windows left so every slice stays in range; at
        # most ONE valid window can clamp (the greedy spacing puts any
        # later start past nbk), so valid windows stay disjoint, and a
        # clamped last window covers every trailing block
        scj = jnp.minimum(sj, nbk - WB)
        covered = jnp.any(
            win_ok[:, None] & (iot[None, :] >= scj[:, None])
            & (iot[None, :] < scj[:, None] + WB), axis=0)
        covered_ok = ~jnp.any(dirty & ~covered)
        # block ids follow the CLAMPED starts (they name the gathered
        # rows); invalid windows get out-of-range ids so every scatter
        # of their garbage rows drops
        ids = jnp.where(win_ok[:, None],
                        scj[:, None] + jnp.arange(WB, dtype=jnp.int32),
                        nbk).reshape(K)
        idc = jnp.minimum(ids, nbk - 1)
        if entry_px32 is None:
            entry_hash0 = jnp.int32(_SEED_HASH)
        else:
            entry_hash0 = _hash_packed(entry_px32[None])[0]

        def gather_windows(x):
            """(m,) -> (K, b): W single-offset slices of WB blocks."""
            return jnp.concatenate([
                jax.lax.dynamic_slice(x, (scj[j] * b,), (WB * b,))
                for j in range(W)]).reshape(K, b)

        def patch_windows(flat, rows):
            """Write (K, b) rows back at their windows; invalid windows
            re-write what was read (a no-op)."""
            rw = rows.reshape(W, WB * b)
            for j in range(W):
                cur = jax.lax.dynamic_slice(flat, (scj[j] * b,), (WB * b,))
                new = jnp.where(win_ok[j], rw[j], cur)
                flat = jax.lax.dynamic_update_slice(flat, new, (scj[j] * b,))
            return flat

        def surgical(state):
            px_prev, _, it, _, _ = state
            w_prev = w0  # the surgical runs only at it == 1
            base_g = gather_windows(base_f)             # (K, b)
            d32_g = gather_windows(d32)
            lit32_g = gather_windows(lit32)
            px_g = gather_windows(px_prev)
            cls_g = base_g & 7
            r6_g = (base_g >> 9) & 63
            starts_g = cls_g != 0
            # per-block entry hash: the w0 chain entering the block (its
            # prefix is certificate-clean up to the first mismatch)
            seed_h = jnp.where(idc == 0, entry_hash0,
                               w0i[jnp.maximum(idc * b - 1, 0)])
            w1_g = jnp.where(
                starts_g,
                _anchored_w_rows(cls_g, r6_g, d32_g, px_g, seed_h), 0)
            # narrow pass 1 over the dirty windows only
            meta_g = (base_g.T | (w1_g.T << 3)).astype(jnp.int32)
            root_g, val_g, proot_g, pval_g = _block_maps(
                meta_g, d32_g.T, lit32_g.T, K, b, emit_px=True)
            root2 = root1.at[:, ids].set(root_g, mode="drop")
            val2 = val1.at[:, ids].set(val_g, mode="drop")
            entry2, exit2 = _compose_entry_states(
                root2, val2, nbk, entry65, return_exit=True)
            # clean blocks: exact delta apply; dirty blocks: fresh apply
            delta = _swar_sub(entry2, entry1)
            px2_p = _apply_symbolic(proot1, _pos_major(px_prev, m, b),
                                    delta)
            px_d = _apply_symbolic(proot_g, pval_g,
                                   jnp.take(entry2, idc, axis=1))
            px2 = patch_windows(px2_p.T.reshape(m), px_d.T)
            w2 = patch_windows(w_prev, jnp.where(starts_g, w1_g, 0))
            # the full certificate is the correctness anchor
            true_w = jnp.where(starts, _hash_packed(px2), 0)
            bad = jnp.sum((true_w != w2).astype(jnp.int32))
            return (px2, bad == 0, it + 1, bad, exit2)

        def cond_s(state):
            _, conv, it, bad, _ = state
            return (~conv & (it == 1) & (bad > 0) & covered_ok)

        state = jax.lax.while_loop(cond_s, surgical, state)

    px, conv, rounds, _, exit65 = jax.lax.while_loop(cond, body, state)
    return px, starts, npix, pix_off, conv, rounds, exit65


@functools.partial(jax.jit, static_argnames=(
    "n_px_cap", "max_rounds", "surgical"))
def _decode_device(data, chunks_len, n_px_cap: int,
                   max_rounds: int = _MAX_ROUNDS, surgical: bool = True):
    px, starts, npix, pix_off, conv, rounds, _ = _decode_core(
        data, chunks_len, max_rounds, surgical=surgical)
    with profiling.annotate("qoi.decode.expand"):
        out = expand.expand_px(pix_off, px, n_px_cap)
    return out, conv, rounds


@functools.partial(jax.jit, static_argnames=("n_px_cap", "max_rounds"))
def _decode_device_batch(data, chunks_len, n_px_cap: int,
                         max_rounds: int = _MAX_ROUNDS):
    return jax.vmap(
        lambda d, c: _decode_device(d, c, n_px_cap, max_rounds,
                                    surgical=False)
    )(data, chunks_len)


@functools.partial(jax.jit, static_argnames=(
    "n_px_cap", "max_rounds", "sub_batch"))
def _decode_device_batch_chunked(data, chunks_len, n_px_cap: int,
                                 max_rounds: int = _MAX_ROUNDS,
                                 sub_batch: int = 8):
    """Large-batch decode as ONE program: lax.map over vmapped sub-batches.

    A flat vmap over B streams holds every stream's intermediates live at
    once (~0.4 GB of (M,) int32 families per 4K stream); sequential
    sub-batches bound peak memory at sub_batch streams while the whole
    batch stays one dispatch."""
    b = data.shape[0]
    if b % sub_batch:
        raise ValueError(f"batch {b} not divisible by sub_batch {sub_batch}")
    d = data.reshape(b // sub_batch, sub_batch, data.shape[1])
    c = chunks_len.reshape(b // sub_batch, sub_batch)
    out, conv, rounds = jax.lax.map(
        lambda dc: jax.vmap(
            lambda x, y: _decode_device(x, y, n_px_cap, max_rounds,
                                        surgical=False))(dc[0], dc[1]),
        (d, c))
    return (out.reshape(b, -1), conv.reshape(b), rounds.reshape(b))


def unpack_px32(px32: np.ndarray) -> np.ndarray:
    """(..., N) uint32 -> (..., N, 4) uint8 rgba (little-endian layout)."""
    return np.ascontiguousarray(px32).view(np.uint8).reshape(
        px32.shape + (4,))


def decode_group(data: jnp.ndarray, chunks_len: jnp.ndarray, n_px_cap: int,
                 max_rounds: int = _MAX_ROUNDS, sub_batch: int = 16):
    """Batched device decode for same-bucket streams. data: (B, M) uint8;
    chunks_len: (B,) int32. Returns (px32 (B, n_px_cap) uint32, converged
    (B,) bool). Batches larger than `sub_batch` (and divisible by it) run
    as ONE program that lax.maps vmapped sub-batches, bounding peak
    memory at `sub_batch` lanes; smaller batches run one flat vmap.
    sub_batch=16 was sized for a 16 GB device and is not yet re-swept
    for larger ones."""
    b = data.shape[0]
    if b > sub_batch and b % sub_batch == 0:
        out, conv, _ = _decode_device_batch_chunked(
            data, chunks_len, n_px_cap, max_rounds=max_rounds,
            sub_batch=sub_batch)
    else:
        out, conv, _ = _decode_device_batch(data, chunks_len, n_px_cap,
                                            max_rounds=max_rounds)
    return out, conv


def decode(data: bytes, channels: int = 0,
           config=None) -> Tuple[np.ndarray, fmt.StreamDesc]:
    """Decode a QOI stream via the blocked symbolic pipeline;
    pixel-identical to the reference decoder (qoi.h:488). Falls back to
    the native decoder (or the v1 pipeline without it) on fixpoint
    non-convergence. `config` (an EngineConfig) tunes the fixpoint cap
    and shape-bucketing floor."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")
    desc = fmt.unpack_header(data)
    out_ch = channels if channels else desc.channels
    max_rounds = config.decode_max_iters if config else _MAX_ROUNDS
    floor = config.bucket_floor if config else 256

    chunks = np.frombuffer(data, dtype=np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(data) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    cap = v1.bucket_size_fine(len(chunks), floor)
    padded = np.zeros((cap,), np.uint8)
    padded[: len(chunks)] = chunks

    px32, conv, _ = _decode_device(
        jnp.asarray(padded), jnp.int32(chunks_len),
        v1.bucket_size(desc.num_pixels, floor), max_rounds=max_rounds)
    if not bool(jax.device_get(conv)):
        return _decode_ladder(data, channels)
    img = unpack_px32(np.asarray(jax.device_get(px32)))[
        : desc.num_pixels, :out_ch]
    return img.reshape(desc.height, desc.width, out_ch), desc


def _decode_ladder(data: bytes, channels: int = 0):
    """Fallback for fixpoint non-convergence (non-canonical streams:
    INDEX reads of unwritten slots break the r6 anchor's table
    invariant, reference semantics qoi.h:540-587). The native C++
    decoder (cpp/qoi_oracle.cpp — this framework's host component)
    decodes such streams at single-core speed, which bounds the
    adversarial-decode cost near the reference's own rate instead of a
    per-byte sequential device scan. The v1 device fixpoint + lax.scan
    anchor remain as the no-native-build ladder."""
    from .. import oracle

    if oracle.available():
        img, desc = oracle.decode(data, channels)
        return img, desc
    return v1.decode(data, channels)
