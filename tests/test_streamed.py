"""Streamed tile-chained encode vs the oracle: every carry crosses tile
boundaries (runs, 62-cap phase, table state, boundary pixel)."""
import numpy as np
import pytest

import qoi_tpu.format as fmt
from qoi_tpu import oracle
from qoi_tpu.models import streamed
from qoi_tpu.utils import testimages

pytestmark = [
    pytest.mark.skipif(not oracle.available(), reason="oracle not built"),
    pytest.mark.slow,  # quick tier: -m "not slow"
]


def _check(img, tile_px):
    h, w, ch = img.shape
    desc = fmt.StreamDesc(w, h, ch)
    assert streamed.encode(img, desc, tile_px=tile_px) == oracle.encode(img, desc)


@pytest.mark.parametrize("tile_px", [256, 1024])
def test_streamed_mixed(tile_px):
    _check(testimages.mixed(100, 40, 4), tile_px)


def test_streamed_run_across_many_tiles():
    _check(testimages.flat(64, 40, 4), 256)  # one 2560-px run over 10 tiles


def test_streamed_run_cap_aligned():
    _check(testimages.flat(62 * 4, 2, 4), 62 * 4)  # tiles end on cap flushes


def test_streamed_table_reuse_across_tiles():
    _check(testimages.palette(128, 20, 4, colors=7, seed=9), 256)


def test_streamed_odd_sizes_and_padding():
    _check(testimages.gradient(97, 13, 3), 256)
    _check(testimages.noise(301, 3, 4, seed=4), 512)


def test_streamed_single_tile_path():
    img = testimages.mixed(50, 20, 3)
    _check(img, 1 << 22)


# ---------------------------------------------------------------------------
# Streamed DECODE (huge-image tile-serial loop)
# ---------------------------------------------------------------------------

def _check_decode(img, tile_bytes, channels=0, max_rounds=12):
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    got, desc = streamed.decode(
        stream, channels=channels, tile_bytes=tile_bytes,
        max_rounds=max_rounds)
    want, _ = oracle.decode(stream, channels)
    assert desc.width == w and desc.height == h
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile_bytes", [2048, 8192])
def test_streamed_decode_multi_tile(tile_bytes):
    _check_decode(testimages.photo(200, 120, 4, seed=7), tile_bytes)


def test_streamed_decode_rgb():
    _check_decode(testimages.mixed(150, 90, 3, seed=5), 4096)


def test_streamed_decode_runs_cross_tiles():
    # one giant run: a single tile emits far more pixels than bytes
    _check_decode(testimages.flat(500, 40, 4), 1024)


def test_streamed_decode_table_reuse_across_tiles():
    _check_decode(testimages.palette(128, 60, 4, colors=7, seed=9), 2048)


def test_streamed_decode_channel_forcing():
    _check_decode(testimages.photo(100, 60, 4), 2048, channels=3)
    _check_decode(testimages.mixed(80, 50, 3), 2048, channels=4)


def test_streamed_decode_truncated_stream():
    img = testimages.photo(100, 60, 4)
    stream = oracle.encode(img, fmt.StreamDesc(100, 60, 4))
    trunc = stream[: len(stream) // 2]
    want, _ = oracle.decode(trunc)
    got, _ = streamed.decode(trunc, tile_bytes=2048)
    np.testing.assert_array_equal(got, want)


def test_streamed_decode_fallback_tiles():
    """max_rounds=1 forces non-convergence on alpha-varying + INDEX-heavy
    tiles: the sequential fallback must chain entry/exit state exactly."""
    img = testimages.mixed(123, 77, 4, seed=2)
    _check_decode(img, 2048, max_rounds=1)


def test_streamed_decode_matches_default_engine():
    img = testimages.photo(90, 70, 4, seed=11)
    stream = oracle.encode(img, fmt.StreamDesc(90, 70, 4))
    a, _ = streamed.decode(stream, tile_bytes=1024)
    from qoi_tpu.models import decode_v3
    b, _ = decode_v3.decode(stream)
    np.testing.assert_array_equal(a, b)


def test_facade_streams_huge_decode(monkeypatch):
    """qoi_tpu.decode routes past-threshold streams to the tile driver."""
    import qoi_tpu

    img = testimages.photo(120, 80, 4, seed=13)
    stream = oracle.encode(img, fmt.StreamDesc(120, 80, 4))
    monkeypatch.setattr(qoi_tpu, "STREAM_THRESHOLD_PX", 1000)
    out, _ = qoi_tpu.decode(stream)
    np.testing.assert_array_equal(out, img)


def test_fetch_prefix_edges():
    """utils/fetch.fetch_prefix: piece-aligned and unaligned totals,
    zero, full-buffer, and buffers smaller than one piece."""
    import jax.numpy as jnp

    from qoi_tpu.utils import fetch

    buf = jnp.arange(1000, dtype=jnp.uint32)
    for total in (0, 1, 999, 1000):
        got = fetch.fetch_prefix(buf, total)
        assert got.shape == (total,)
        assert (got == np.arange(total, dtype=np.uint32)).all()
    old = fetch.PIECE
    try:
        fetch.PIECE = 256  # force multi-piece paths incl. clamped last
        for total in (0, 255, 256, 257, 512, 999, 1000):
            got = fetch.fetch_prefix(buf, total)
            assert (got == np.arange(total, dtype=np.uint32)).all()
    finally:
        fetch.PIECE = old


def test_streamed_encode_capacity_fits_s32_at_format_max():
    """The device output buffer must stay under 2^31 u8 elements for the
    LARGEST legal image (400 Mpx, reference qoi.h:329-332): XLA's s32
    index arithmetic corrupts past that (caught by the 400 Mpx envelope
    run — the old 6 B/px capacity was ~2.44e9). The 5 B/px bound is the
    true stream worst case: chunks partition the pixels, each covers
    >= 1 px at <= 5 bytes."""
    n = 399974400  # 25600 x 15624, the widest-legal 400 Mpx shape
    t = 1 << 22
    n_tiles = -(-n // t)
    cap = 5 * n_tiles * t + 6 * t
    assert cap >= 5 * n  # still a valid worst-case stream bound
    assert cap < (1 << 31)
