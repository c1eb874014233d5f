"""Run expansion (ops/expand.py) against an independent numpy expansion.

The decoder hands run expansion per-byte records: pix_off (nondecreasing
pixel offset of the chunk at/after each byte) and px32 (the value after
each byte). Pixel p takes the value of the last byte whose offset is
<= p; pixels before any chunk keep the seed, pixels past the last chunk
repeat its value, offsets at or past the cap are dropped. The numpy
reference below computes exactly that with a binary search, sharing no
code with the telescoping scatter-add + cumsum under test. The record
geometries are the decoder's edge cases: truncation, short streams,
max-sparsity 62-runs, dense 5-byte literals, and their alternation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qoi_tpu import format as fmt
from qoi_tpu.ops import expand

SEED32 = np.uint32(fmt.SEED_PIXEL[0] | fmt.SEED_PIXEL[1] << 8
                   | fmt.SEED_PIXEL[2] << 16 | fmt.SEED_PIXEL[3] << 24)


def _numpy_expand(pix_off, px, cap, seed=SEED32):
    j = np.searchsorted(pix_off, np.arange(cap), side="right") - 1
    return np.where(j >= 0, px[np.maximum(j, 0)], np.uint32(seed)).astype(
        np.uint32)


def _synth_records(m, seed, max_run=62):
    """Chunks of 1-5 bytes, each emitting 1 px except 1-byte chunks,
    which may RUN up to `max_run` px."""
    rng = np.random.default_rng(seed)
    npix = np.zeros(m, np.int64)
    px = np.zeros(m, np.uint32)
    i = 0
    while i < m - 5:
        nbytes = int(rng.integers(1, 6))
        n = int(rng.integers(1, max_run + 1)) if nbytes == 1 else 1
        npix[i] = n
        px[i:i + nbytes] = np.uint32(rng.integers(0, 2**32))
        i += nbytes
    px[i:] = px[i - 1] if i else 0
    pix_off = (np.cumsum(npix) - npix).astype(np.int32)
    return pix_off, px


def _all_one_byte_chunks(m, run_len):
    """Every byte a 1-byte chunk emitting `run_len` px (max sparsity at
    62: offsets advance 62 px per byte)."""
    npix = np.full(m, run_len, np.int64)
    rng = np.random.default_rng(run_len)
    px = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    return (np.cumsum(npix) - npix).astype(np.int32), px


def _run_cycle(m):
    """1-byte runs whose lengths cycle through 1..62."""
    npix = (np.arange(m) % 62 + 1).astype(np.int64)
    rng = np.random.default_rng(4)
    px = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    return (np.cumsum(npix) - npix).astype(np.int32), px


def _alternating(m, seed):
    """62-runs next to bursts of 5-byte RGBA literals: the offset
    density jumps between its extremes mid-plane."""
    rng = np.random.default_rng(seed)
    npix = np.zeros(m, np.int64)
    px = np.zeros(m, np.uint32)
    i = 0
    while i < m - 6:
        if rng.random() < 0.5:
            npix[i] = 62
            px[i] = np.uint32(rng.integers(0, 2**32))
            i += 1
        else:
            for _ in range(int(rng.integers(1, 9))):
                if i >= m - 6:
                    break
                npix[i] = 1
                px[i:i + 5] = np.uint32(rng.integers(0, 2**32))
                i += 5
    px[i:] = px[i - 1]
    return (np.cumsum(npix) - npix).astype(np.int32), px


def _check(pix_off, px, cap, seed=None):
    got = np.asarray(expand.expand_px(
        jnp.asarray(pix_off), jnp.asarray(px), cap,
        seed32=None if seed is None else np.uint32(seed)))
    want = _numpy_expand(pix_off, px, cap,
                         SEED32 if seed is None else np.uint32(seed))
    np.testing.assert_array_equal(got, want)


_GEOMETRIES = {
    "trunc": (600, 512, 0),       # offsets overflow the cap
    "mid": (6000, 4096, 1),
    "short": (100, 2048, 2),      # tail repeats the last chunk px
    "long": (70000, 65536, 3),
}


@pytest.mark.parametrize("form", ["plain", "jit", "vmap", "seed32",
                                  "half_cap"])
@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_expand_matches_numpy(geometry, form):
    m, cap, seed = _GEOMETRIES[geometry]
    pix_off, px = _synth_records(m, seed)
    if form == "plain":
        _check(pix_off, px, cap)
    elif form == "jit":
        got = jax.jit(expand.expand_px, static_argnums=2)(
            jnp.asarray(pix_off), jnp.asarray(px), cap)
        np.testing.assert_array_equal(np.asarray(got),
                                      _numpy_expand(pix_off, px, cap))
    elif form == "vmap":
        po2, px2 = _synth_records(m, seed + 100)
        got = np.asarray(jax.vmap(
            lambda p, x: expand.expand_px(p, x, cap))(
                jnp.asarray(np.stack([pix_off, po2])),
                jnp.asarray(np.stack([px, px2]))))
        np.testing.assert_array_equal(got[0], _numpy_expand(pix_off, px, cap))
        np.testing.assert_array_equal(got[1], _numpy_expand(po2, px2, cap))
    elif form == "seed32":
        _check(pix_off, px, cap, seed=0xDEADBEEF)
    else:
        _check(pix_off, px, cap // 2)


@pytest.mark.parametrize("variant", ["leading_gap", "dup_tail"])
@pytest.mark.parametrize("geometry", ["trunc", "mid", "long"])
def test_expand_offset_edges(geometry, variant):
    """leading_gap: the first chunk starts past pixel 0, so the leading
    pixels keep the seed; dup_tail: trailing bytes that emit nothing
    repeat the last px up to the cap."""
    m, cap, seed = _GEOMETRIES[geometry]
    pix_off, px = _synth_records(m, seed + 10)
    if variant == "leading_gap":
        pix_off = pix_off + 37
    else:
        tail = np.full(64, pix_off[-1], np.int32)
        pix_off = np.concatenate([pix_off, tail])
        px = np.concatenate([px, np.full(64, px[-1], np.uint32)])
    _check(pix_off, px, cap)


def test_expand_vmap_per_lane_seed():
    """Under vmap every lane telescopes from its own seed: a stale seed
    from lane 0 would shift every pixel of lane 1."""
    po1, px1 = _synth_records(6000, 21)
    po2, px2 = _synth_records(6000, 22)
    seeds = np.array([0x11223344, 0xFFFFFFFF], np.uint32)
    got = np.asarray(jax.vmap(
        lambda p, x, s: expand.expand_px(p, x, 4096, seed32=s))(
            jnp.asarray(np.stack([po1, po2])),
            jnp.asarray(np.stack([px1, px2])), jnp.asarray(seeds)))
    np.testing.assert_array_equal(got[0], _numpy_expand(po1, px1, 4096,
                                                        seeds[0]))
    np.testing.assert_array_equal(got[1], _numpy_expand(po2, px2, 4096,
                                                        seeds[1]))


def test_expand_custom_seed():
    """A seed whose deltas wrap mod 2^32 at every chunk."""
    pix_off, px = _synth_records(6000, 23)
    _check(pix_off, px, 4096, seed=0xFFFFFFFF)


def test_expand_all_singles():
    """No runs at all: every chunk 1 px (the densest offset plane)."""
    pix_off, px = _synth_records(20000, 7, max_run=1)
    _check(pix_off, px, 16384)


def test_expand_big_plane():
    pix_off, px = _synth_records(60000, 13)
    _check(pix_off, px, 32768)


@pytest.mark.parametrize("geometry", [
    "max_runs", "max_runs_trunc", "run_cycle", "alternating",
    "alternating_seed6", "alternating_trunc", "dense_singles",
    "past_cap"])
def test_expand_adversarial_geometry(geometry):
    if geometry == "max_runs":
        pix_off, px = _all_one_byte_chunks(4096, 62)
        cap = 65536
    elif geometry == "max_runs_trunc":
        pix_off, px = _all_one_byte_chunks(4096, 62)
        cap = 4096
    elif geometry == "run_cycle":
        pix_off, px = _run_cycle(3000)
        cap = 65536
    elif geometry.startswith("alternating"):
        pix_off, px = _alternating(
            30000, 6 if geometry.endswith("seed6") else 5)
        cap = 8192 if geometry.endswith("trunc") else 32768
    elif geometry == "dense_singles":
        pix_off, px = _synth_records(20000, 11, max_run=1)
        cap = 16384
    else:  # every offset at or past the cap: the plane is all seed
        pix_off, px = _synth_records(2000, 12)
        pix_off = pix_off + 4096
        cap = 4096
    _check(pix_off, px, cap)


@pytest.mark.parametrize("case", ["mixed", "singles", "runs62"])
def test_expand_wide_planes(case):
    """Large record planes of each density extreme."""
    pix_off, px, cap = {
        "mixed": lambda: _synth_records(60000, 17) + (32768,),
        "singles": lambda: _synth_records(20000, 7, max_run=1) + (16384,),
        "runs62": lambda: _all_one_byte_chunks(2048, 62) + (32768,),
    }[case]()
    _check(pix_off, px, cap)
