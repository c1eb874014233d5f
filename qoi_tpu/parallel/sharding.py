"""Mesh construction helpers (SURVEY.md §2.4, §5.8).

The framework has two parallel axes:
  "data" — independent images (DP; BASELINE configs 3, 5)
  "seq"  — pixel tiles of one stream (SP/CP analog; configs 2, 4), with
           cross-tile carry state exchanged via collectives (qoi_tpu/parallel/tiled.py)

There are no weights, so TP/PP/EP have no direct counterpart; the pipeline
stages are fused inside each tile instead (SURVEY §2.4).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_mesh(
    data: int = 1,
    seq: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, seq) mesh over the first data*seq devices.

    Device order follows the algorithm only: the GPUs of one host are
    joined all to all by NVLink and NCCL carries the collectives, so no
    placement is faster than another. The seq axis is innermost so each
    stream's tiles are consecutive devices; data-parallel traffic is only
    final counter psums (SURVEY §5.8).
    """
    if devices is None:
        devices = jax.devices()
    n = data * seq
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(data, seq)
    return Mesh(arr, axis_names=(DATA_AXIS, SEQ_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
