"""Batched encode/decode: many independent streams per device (DP axis).

BASELINE configs 3 and 5: each image is its own seed-state stream (exactly
a standalone reference-compatible file), so there is no cross-stream carry —
the batch axis is embarrassingly parallel and maps onto `vmap` within a chip
and the "data" mesh axis across chips (qoi_tpu/parallel/sharding.py).

Shape bucketing keeps the number of compiled programs O(log max-size):
images are grouped by their power-of-two pixel bucket (per-image true
sizes stay dynamic `n_valid` operands). Encode dispatches the fused
word-sum program once per image of a group; decode runs each group of
streams as one vmapped program. Invalid inputs are flagged per-image and
the batch continues (SURVEY §5.3: failure detection without elastic
recovery).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import format as fmt
from ..utils import fetch
from . import decode_pipeline, decode_v3, pipeline


@jax.jit
def _stack_totals(totals):
    return jnp.stack(totals)


def encode_batch(
    images: Sequence[np.ndarray],
    descs: Optional[Sequence[fmt.StreamDesc]] = None,
) -> List[bytes]:
    """Encode a batch of images (each (h, w, 3|4) uint8); returns one
    reference-compatible stream per image, byte-identical to encoding each
    alone."""
    if descs is None:
        descs = [
            fmt.StreamDesc(im.shape[1], im.shape[0], im.shape[2])
            for im in images
        ]
    groups: Dict[int, List[int]] = collections.defaultdict(list)
    for i, d in enumerate(descs):
        d.validate()
        groups[pipeline.bucket_size(d.num_pixels)].append(i)

    out: List[bytes] = [b""] * len(images)
    for bucket, idxs in sorted(groups.items()):
        px = np.zeros((len(idxs), bucket, 4), np.uint8)
        nv = np.zeros((len(idxs),), np.int32)
        for row, i in enumerate(idxs):
            flat = pipeline.force_rgba(images[i], descs[i])
            px[row, : flat.shape[0]] = flat
            nv[row] = flat.shape[0]
        # the fused word-sum program (what bench.py times), one dispatch
        # per image, all queued before the one totals fetch; each
        # stream's words then come back as a prefix of its buffer
        devouts = [
            pipeline.encode_device_wordsum(
                jnp.asarray(px[row]), jnp.int32(nv[row]))
            for row in range(len(idxs))
        ]
        tots = np.asarray(jax.device_get(
            _stack_totals([t for _, t in devouts])))
        for row, i in enumerate(idxs):
            words, _ = devouts[row]
            body = fetch.fetch_prefix(
                words, -(-int(tots[row]) // 4)).view(np.uint8)
            out[i] = (
                fmt.pack_header(descs[i])
                + body[: int(tots[row])].tobytes()
                + fmt.TRAILER
            )
    return out


def decode_batch(
    streams: Sequence[bytes], channels: int = 0
) -> List[Tuple[Optional[np.ndarray], Optional[fmt.StreamDesc], Optional[str]]]:
    """Decode a batch of QOI streams. Returns per-stream
    (pixels, desc, error): invalid streams get (None, None, message) and the
    rest of the batch proceeds (SURVEY §5.3)."""
    if channels not in (0, 3, 4):
        raise ValueError(f"channels must be 0, 3 or 4, got {channels}")

    parsed: List[Optional[fmt.StreamDesc]] = []
    errors: List[Optional[str]] = []
    for s in streams:
        try:
            parsed.append(fmt.unpack_header(s))
            errors.append(None)
        except ValueError as e:
            parsed.append(None)
            errors.append(str(e))

    groups: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for i, d in enumerate(parsed):
        if d is None:
            continue
        cap = decode_pipeline.bucket_size_fine(
            len(streams[i]) - fmt.HEADER_SIZE)
        npc = decode_pipeline.bucket_size(d.num_pixels)
        groups[(cap, npc)].append(i)

    results: List[Tuple] = [(None, None, e) for e in errors]
    for (cap, npc), idxs in sorted(groups.items()):
        data = np.zeros((len(idxs), cap), np.uint8)
        clens = np.zeros((len(idxs),), np.int32)
        for row, i in enumerate(idxs):
            body = np.frombuffer(streams[i], np.uint8)[fmt.HEADER_SIZE:]
            data[row, : body.shape[0]] = body
            clens[row] = len(streams[i]) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
        px32, conv = decode_v3.decode_group(
            jnp.asarray(data), jnp.asarray(clens), npc)
        px32 = np.asarray(jax.device_get(px32))  # (B, npc) packed u32
        conv = np.asarray(jax.device_get(conv))  # (B,) per-stream
        for row, i in enumerate(idxs):
            d = parsed[i]
            out_ch = channels if channels else d.channels
            if conv[row]:
                img = decode_v3.unpack_px32(px32[row])[
                    : d.num_pixels, :out_ch].reshape(
                    d.height, d.width, out_ch)
            else:  # adversarial stream: certified fallback
                img, _ = decode_pipeline.decode(streams[i], channels)
            results[i] = (img, d, None)
    return results
