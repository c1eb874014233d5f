"""Run expansion: per-byte decode results -> the pixel plane.

The decoder's last stage maps every output pixel p to the px of its
governing chunk: the last chunk start with pix_off <= p (reference run
semantics qoi.h:532-544). With d[i] = px32[i] - px32[i-1] in Z/2^32
(px32[-1] := seed), that px telescopes:

    px32[j*(p)] = seed + sum_{i <= j*(p)} d[i]

where j*(p) is the last byte with pix_off <= p. pix_off is nondecreasing
and every chunk start has a unique pixel offset (chunks emit >= 1 px;
chunk-tail bytes carry the next chunk's offset with d = 0 there), so

    out = cumsum(landed) + seed,   landed[p] = sum_i d[i] * [pix_off[i] == p]

`landed` is one sorted scatter-add of the byte deltas into the plane; the
cumsum finishes it. No per-channel isolation is needed: the sums
telescope to differences of whole packed pixels.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import format as fmt

_SEED32 = np.uint32(
    fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
    | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24).view(np.int32)


def expand_px(pix_off, px32, n_px_cap: int, seed32=None):
    """Per-pixel packed-u32 plane from per-byte decode results.

    pix_off: (M,) int32 nondecreasing pixel offset of the chunk at/after
    each byte (exclusive cumsum of per-byte pixel counts: tail bytes carry
    the next chunk's offset); px32: (M,) uint32 value after each byte
    (changes only at chunk starts); seed32: the px entering the stream
    (default the format's seed pixel; tiled and streamed decodes pass the
    tile's entry px). Pixels past the last chunk repeat its value, pixels
    before any chunk get the seed (truncation tolerance, qoi.h:544), and
    offsets at or past `n_px_cap` are dropped. Returns (n_px_cap,) uint32.
    """
    seed = (jnp.int32(_SEED32) if seed32 is None
            else jnp.asarray(seed32).view(jnp.int32).reshape(()))
    px_i = px32.view(jnp.int32)
    prev = jnp.concatenate([seed[None], px_i[:-1]])
    d = px_i - prev
    plane = jnp.zeros((n_px_cap,), jnp.int32).at[
        pix_off.astype(jnp.int32)].add(d, mode="drop", indices_are_sorted=True)
    return (jnp.cumsum(plane) + seed).view(jnp.uint32)
