"""qoi_tpu — a data-parallel QOI (Quite OK Image) encode/decode engine.

Built from scratch in JAX/XLA with C++ host components; bit-exact
against the reference format (see SURVEY.md for the structural analysis and
the parallel reformulation of the reference's sequential codec).
"""

from .format import (  # noqa: F401
    LINEAR,
    SRGB,
    StreamDesc,
    pack_header,
    unpack_header,
)

__version__ = "0.1.0"


#: pixel count above which the all-at-once pipeline's intermediates would
#: strain one device's memory; larger images stream tile-by-tile instead.
#: Sized for a 16 GB device; not yet re-swept for larger ones.
STREAM_THRESHOLD_PX = 1 << 24


def encode(pixels, desc=None, engine="tpu") -> bytes:
    """Encode pixels ((h, w, 3|4) uint8, or flat with an explicit desc) to a
    QOI stream, byte-identical to the reference encoder (qoi.h:356). Huge
    images (reference cap: 400 Mpx, qoi.h:329-332) automatically use the
    tile-streaming path (models/streamed.py). `engine` is a name or a full
    EngineConfig (SURVEY §5.6)."""
    from . import io as _io

    c = _io._as_config(engine)
    if desc is None:
        desc = _io.image_desc(pixels)
    if c.engine == "tpu" and desc.num_pixels > STREAM_THRESHOLD_PX:
        from .models import streamed

        return streamed.encode(pixels, desc, config=c)
    enc, _ = _io._engine(c)
    return enc(pixels, desc)


def decode(data: bytes, channels: int = 0, engine="tpu"):
    """Decode a QOI stream to ((h, w, ch) uint8, StreamDesc), pixel-identical
    to the reference decoder (qoi.h:488). Huge images (reference cap:
    400 Mpx, qoi.h:329-332) automatically use the tile-streaming decoder
    (models/streamed.py) so device memory stays O(tile). `engine` is a name
    or a full EngineConfig."""
    from . import io as _io

    c = _io._as_config(engine)
    if c.engine == "tpu":
        from .format import unpack_header

        if unpack_header(data).num_pixels > STREAM_THRESHOLD_PX:
            from .models import streamed

            return streamed.decode(data, channels, config=c)
    _, dec = _io._engine(c)
    return dec(data, channels)
