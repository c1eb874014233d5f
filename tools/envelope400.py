#!/usr/bin/env python3
"""The full 400 Mpx format-envelope proof (reference cap qoi.h:329-332).

Runs the largest legal image once through the streamed tile-serial
paths on the device:

  25600 x 15624 RGBA = 399,974,400 px — the LARGEST legal image at
  width 25600 (the header validator mirrors the reference's
  height >= QOI_PIXELS_MAX / width rejection, qoi.h:331).

Encode via models/streamed.encode (device-driven tile loop), verify
byte-identical to the C++ oracle; decode the oracle's stream via
models/streamed.decode, verify pixel-identical to the source. Prints
one summary line per direction; wall-clock includes the host<->device
pixel transfers.

    python tools/envelope400.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from qoi_tpu.utils import profiling  # noqa: E402

profiling.enable_compile_cache()

import numpy as np  # noqa: E402

import qoi_tpu  # noqa: E402
from qoi_tpu import oracle  # noqa: E402
from qoi_tpu.models import streamed  # noqa: E402
from qoi_tpu.utils import testimages  # noqa: E402

W, H = 25600, 15624
N = W * H


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import jax

    log(f"device: {jax.devices()[0]}")
    desc = qoi_tpu.StreamDesc(W, H, 4)
    desc.validate()

    t0 = time.perf_counter()
    img = testimages.mixed(W, H, 4, seed=11)
    log(f"image built: {N/1e6:.1f} Mpx, {img.nbytes/2**30:.2f} GiB "
        f"({time.perf_counter()-t0:.0f}s)")

    t0 = time.perf_counter()
    want = oracle.encode(img, desc)
    t_or = time.perf_counter() - t0
    log(f"oracle encode: {len(want)/2**20:.0f} MiB "
        f"({N/1e6/t_or:.0f} Mpx/s single-core, {t_or:.1f}s)")

    t0 = time.perf_counter()
    mine = streamed.encode(img, desc)
    t_enc = time.perf_counter() - t0
    ok_enc = mine == want
    print(f"encode 400Mpx: {t_enc:.1f}s wall ({N/1e6/t_enc:.2f} Mpx/s), "
          f"byte-identical={ok_enc}", flush=True)
    del mine

    t0 = time.perf_counter()
    out, desc2 = streamed.decode(want)
    t_dec = time.perf_counter() - t0
    ok_dec = (desc2.width, desc2.height) == (W, H) and bool(
        np.array_equal(out.reshape(-1, 4), img.reshape(-1, 4)))
    print(f"decode 400Mpx: {t_dec:.1f}s wall ({N/1e6/t_dec:.2f} Mpx/s), "
          f"pixel-identical={ok_dec}", flush=True)
    assert ok_enc and ok_dec


if __name__ == "__main__":
    main()
