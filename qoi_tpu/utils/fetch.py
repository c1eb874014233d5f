"""Fixed-shape device->host prefix fetches.

Encode outputs live in worst-case-capacity buffers (6 B/px) of which a
stream uses a fraction. `jax.device_get(buf)` would copy the FULL buffer
to the host, and a python-int slice `buf[:total]` compiles a fresh slice
program per distinct size. Fetching in fixed-shape pieces moves only
~total bytes and compiles one slicer per piece size."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: elements per fetch piece (one compiled slice program reused)
PIECE = 1 << 22


@functools.lru_cache(maxsize=None)
def _piece_slicer(p: int):
    """One jitted fixed-shape slicer per piece size, reused across calls
    (a per-call lambda would have a fresh identity and re-trace every
    time)."""
    return jax.jit(functools.partial(
        lambda b, o, p: jax.lax.dynamic_slice(b, (o,), (p,)), p=p))


def fetch_prefix(buf, total: int) -> np.ndarray:
    """Fetch buf[:total] (any 1-D dtype) in fixed-shape pieces."""
    p = min(PIECE, buf.shape[0])
    piece = _piece_slicer(p)
    out = []
    for off in range(0, total, p):
        # dynamic_slice clamps the start so the last piece reads a
        # window ending exactly at the buffer end; compensate on host
        start = min(off, buf.shape[0] - p)
        raw = np.asarray(jax.device_get(piece(buf, jnp.int32(start))))
        out.append(raw[off - start: off - start + min(p, total - off)])
    if not out:
        return np.zeros((0,), np.asarray(jax.device_get(buf[:0])).dtype)
    return np.concatenate(out)
