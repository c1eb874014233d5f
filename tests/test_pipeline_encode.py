"""Parallel encode pipeline vs oracle: must be byte-identical
(SURVEY.md §7.4 step 4 differential strategy)."""
import functools
import zlib

import numpy as np
import pytest

from qoi_tpu import format as fmt
from qoi_tpu import oracle
from qoi_tpu.models import pipeline
from qoi_tpu.ops import compact, scans
from qoi_tpu.utils import testimages

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.skipif(not oracle.available(), reason="no C++ toolchain")


@pytest.mark.parametrize("ch", [3, 4])
def test_encode_matches_oracle(ch):
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        desc = fmt.StreamDesc(w, h, ch)
        expect = oracle.encode(img, desc)
        got = pipeline.encode(img, desc)
        assert got == expect, (
            f"{name}: {len(got)} vs {len(expect)} bytes; "
            f"first diff at {next((i for i, (a, b) in enumerate(zip(got, expect)) if a != b), -1)}"
        )


def test_encode_random_images():
    rng = np.random.default_rng(11)
    for _ in range(8):
        w, h = int(rng.integers(1, 80)), int(rng.integers(1, 40))
        ch = int(rng.choice([3, 4]))
        style = int(rng.integers(0, 3))
        if style == 0:
            img = rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)
        elif style == 1:
            img = rng.integers(0, 3, size=(h, w, ch), dtype=np.uint8) * 90
        else:
            pal = rng.integers(0, 256, size=(4, ch), dtype=np.uint8)
            img = pal[rng.integers(0, 4, size=(h, w))]
        desc = fmt.StreamDesc(w, h, ch)
        assert pipeline.encode(img, desc) == oracle.encode(img, desc)


def test_run_segmentation_props():
    # all-equal stream of 130: emission at 62, 124, and the final pixel (6)
    eq = jnp.ones(130, bool)
    runs = scans.run_segmentation(eq)
    pts = np.flatnonzero(np.asarray(runs.emits_run))
    assert list(pts) == [61, 123, 129]
    vals = np.asarray(runs.run_val)[pts]
    assert list(vals) == [62, 62, 6]
    # no flushes since nothing is a literal
    assert not np.asarray(runs.flush).any()


def test_flush_after_run():
    eq = jnp.array([False, True, True, False, False])
    runs = scans.run_segmentation(eq)
    assert list(np.asarray(runs.flush)) == [False, False, False, True, False]
    assert np.asarray(runs.flush_val)[3] == 2


def test_compact_merge_equals_scatter():
    rng = np.random.default_rng(3)
    n, k = 64, 6
    staging = rng.integers(1, 256, size=(n, k), dtype=np.uint8)
    lens = rng.integers(0, k + 1, size=(n,)).astype(np.int32)
    cap = int(lens.sum()) + 8
    a, ta = compact.compact_bytes(jnp.asarray(staging), jnp.asarray(lens), cap)
    b, tb = compact.compact_bytes_merge(jnp.asarray(staging), jnp.asarray(lens))
    assert int(ta) == int(tb) == lens.sum()
    assert np.array_equal(np.asarray(a)[: int(ta)], np.asarray(b)[: int(tb)])


@pytest.mark.parametrize("n", [4096 * 3, 4096 * 2 + 100, 512, 64])
@pytest.mark.parametrize("lens_kind", ["mixed", "dense6", "sparse", "empty"])
def test_compact_bytes6_wordsum(n, lens_kind):
    """The word-sum placement primitive (cumsum-difference assembly, no
    sort/gather/kernel) must agree byte-for-byte with the sort-based
    compaction across segment geometries (multi-segment, fallback seg=n)
    and record-length regimes, including totals not divisible by 4 and
    all-empty stagings."""
    rng = np.random.default_rng(n * 7 + len(lens_kind))
    k = 6
    staging = rng.integers(1, 256, size=(n, k), dtype=np.uint8)
    if lens_kind == "mixed":
        lens = rng.integers(0, k + 1, size=(n,)).astype(np.int32)
    elif lens_kind == "dense6":
        lens = np.full((n,), 6, np.int32)
        lens[-1] = 5  # force a final partial word
    elif lens_kind == "sparse":
        lens = np.where(rng.random(n) < 0.05,
                        rng.integers(1, k + 1, size=(n,)), 0).astype(np.int32)
    else:
        lens = np.zeros((n,), np.int32)
    cap = ((n * k + 3) // 4) * 4
    a, ta = compact.compact_bytes6_wordsum(
        jnp.asarray(staging.T.copy()), jnp.asarray(lens), cap)
    b, tb = compact.compact_bytes(jnp.asarray(staging), jnp.asarray(lens), cap)
    assert int(ta) == int(tb) == lens.sum()
    assert np.array_equal(np.asarray(a)[: int(ta)], np.asarray(b)[: int(tb)])
    # the radix-4 slide (two distance bits per pass) and the words_out
    # form (u32 little-endian words, host .view is free) must agree too
    a4, t4 = compact.compact_bytes6_wordsum(
        jnp.asarray(staging.T.copy()), jnp.asarray(lens), cap, radix=4)
    assert int(t4) == int(ta)
    assert np.array_equal(np.asarray(a4)[: int(ta)], np.asarray(b)[: int(tb)])
    w, tw = compact.compact_bytes6_wordsum(
        jnp.asarray(staging.T.copy()), jnp.asarray(lens), cap,
        words_out=True)
    assert int(tw) == int(ta)
    assert np.array_equal(
        np.asarray(w).view(np.uint8)[: int(ta)], np.asarray(b)[: int(tb)])
    # subrow-relative slide (log2(sub_rows) passes + subrow scatter)
    lo, hl = compact._record_words(
        jnp.asarray(staging.T.copy()), jnp.asarray(lens))
    for r in (128, 512):
        sr, tr = compact.compact_words6_wordsum(
            lo.view(jnp.uint32), (hl & 0xFFFF).view(jnp.uint32),
            jnp.asarray(lens), cap, sub_rows=r)
        assert int(tr) == int(ta)
        assert np.array_equal(np.asarray(sr)[: int(ta)],
                              np.asarray(b)[: int(tb)])


@pytest.mark.parametrize("case", ["mixed", "palette_alpha", "flat", "noise"])
def test_stage_words_matches_bytes(case):
    """form='words' staging must emit exactly the (lo, hi) record words
    ops/compact._record_words derives from the byte-plane staging, for
    every chunk class (runs/flush, INDEX, DIFF, LUMA, RGB, RGBA), plus
    an identical carry."""
    w, h = 120, 50
    img = {"mixed": lambda: testimages.mixed(w, h, 4),
           "palette_alpha": lambda: testimages.palette_alpha(w, h),
           "flat": lambda: testimages.flat(w, h, 4),
           "noise": lambda: testimages.noise(w, h, 4)}[case]()
    px4 = jnp.asarray(pipeline.force_rgba(img, fmt.StreamDesc(w, h, 4)))
    cb = pipeline.encode_stage_chunks(px4, jnp.int32(w * h))
    lo_b, hl_b = compact._record_words(cb.staging, cb.lens)
    cw = pipeline.encode_stage_chunks(px4, jnp.int32(w * h), form="words")
    assert np.array_equal(np.asarray(cw.lens), np.asarray(cb.lens))
    assert np.array_equal(np.asarray(cw.lo),
                          np.asarray(lo_b).view(np.uint32))
    assert np.array_equal(np.asarray(cw.hi),
                          np.asarray(hl_b).view(np.uint32) & 0xFFFF)
    for a, b in zip(cw.carry, cb.carry):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # end-to-end: the fused words program is byte-identical to the oracle
    words, total = pipeline.encode_device_wordsum(
        px4, jnp.int32(w * h), seg=1024)
    stream = (fmt.pack_header(fmt.StreamDesc(w, h, 4))
              + np.asarray(words).view(np.uint8)[: int(total)].tobytes()
              + fmt.TRAILER)
    assert stream == oracle.encode(
        pipeline.force_rgba(img, fmt.StreamDesc(w, h, 4)).reshape(h, w, 4),
        fmt.StreamDesc(w, h, 4))


@pytest.mark.parametrize("n", [4096 * 3, 4096 * 2 + 100, 512])
def test_compact_bytes6_both_tiers(n):
    """compact_bytes6's two-tier segment-sort path (n divisible by the
    4096 segment, n >= 2 segments) and its global-sort fallback must agree
    with the plain sort-based compaction byte for byte."""
    rng = np.random.default_rng(n)
    k = 6
    staging = rng.integers(1, 256, size=(n, k), dtype=np.uint8)
    lens = rng.integers(0, k + 1, size=(n,)).astype(np.int32)
    cap = n * k
    a, ta = compact.compact_bytes6(
        jnp.asarray(staging.T.copy()), jnp.asarray(lens), cap)
    b, tb = compact.compact_bytes(jnp.asarray(staging), jnp.asarray(lens), cap)
    assert int(ta) == int(tb) == lens.sum()
    assert np.array_equal(np.asarray(a)[: int(ta)], np.asarray(b)[: int(tb)])


# ---------------------------------------------------------------------------
# Stages 1-4 (encode_stage_chunks) on their own: the per-pixel records,
# concatenated in numpy, must be the oracle's stream body — in byte-plane
# form and in packed-word form, through padding and multi-block tables.
# ---------------------------------------------------------------------------

def _records_from_planes(staging6, lens):
    return b"".join(staging6[: lens[i], i].tobytes()
                    for i in range(lens.shape[0]))


def _records_from_words(lo, hi, lens):
    words = np.stack([lo, hi], axis=1).astype("<u4").view(np.uint8)
    words = words.reshape(-1, 8)
    return b"".join(words[i, : lens[i]].tobytes()
                    for i in range(lens.shape[0]))


_stage_jit = jax.jit(pipeline.encode_stage_chunks, static_argnames=("form",))


def _stage_check(img):
    from qoi_tpu.models import scan_codec

    h, w, ch = img.shape
    desc = fmt.StreamDesc(w, h, ch)
    px4 = pipeline.force_rgba(img, desc)
    n = px4.shape[0]
    padded = np.zeros((pipeline.bucket_size(n), 4), np.uint8)
    padded[:n] = px4
    want = oracle.encode(img, desc)[fmt.HEADER_SIZE:-fmt.TRAILER_SIZE]
    assert scan_codec.encode(img, desc)[
        fmt.HEADER_SIZE:-fmt.TRAILER_SIZE] == want

    cb = _stage_jit(jnp.asarray(padded), jnp.int32(n))
    lens = np.asarray(cb.lens)
    assert not lens[n:].any(), "padding pixels must emit nothing"
    assert _records_from_planes(np.asarray(cb.staging), lens) == want
    cw = _stage_jit(jnp.asarray(padded), jnp.int32(n), form="words")
    assert np.array_equal(np.asarray(cw.lens), lens)
    assert _records_from_words(np.asarray(cw.lo), np.asarray(cw.hi),
                               lens) == want


@pytest.mark.parametrize("name", ["gradient", "palette", "mixed", "flat_70px",
                                  "noise_small", "runs_caps", "seed_run",
                                  "wraparound", "alpha_toggle"])
def test_stage_chunks_edge_cases(name):
    _stage_check(testimages.edge_case_suite(4)[name])


def test_stage_chunks_rgb():
    _stage_check(testimages.mixed(64, 20, 3))


def test_stage_chunks_multiblock_runs():
    """Runs longer than the 62-cap crossing table blocks."""
    _stage_check(testimages.flat(300, 4, 4))


def test_stage_chunks_table_carry():
    """Palette repeats crossing table blocks exercise the cross-block
    last-writer carry."""
    _stage_check(testimages.palette(300, 4, 4, colors=9, seed=5))


def test_stage_chunks_padding_tail():
    _stage_check(testimages.noise(97, 5, 4, seed=8))


# ---------------------------------------------------------------------------
# The word-sum compaction on record-length extremes, against a numpy
# concatenation of the records.
# ---------------------------------------------------------------------------

def _random_staging(n, rng, p_zero=0.5):
    lens = rng.choice([0, 1, 2, 3, 4, 5, 6], size=n,
                      p=[p_zero] + [(1 - p_zero) / 6] * 6)
    staging = rng.integers(0, 256, size=(6, n), dtype=np.uint8)
    staging = np.where(np.arange(6)[:, None] < lens[None, :], staging, 0)
    return staging.astype(np.uint8), lens.astype(np.int32)


def _masked(staging, lens):
    return np.where(np.arange(6)[:, None] < lens[None, :], staging,
                    0).astype(np.uint8)


def _lens_case(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case.startswith("random"):
        n = {"random_small": 1 << 10}.get(case, 1 << 14)
        return _random_staging(n, rng)
    if case == "segment_boundary":
        n = 4096 * 4
        staging, _ = _random_staging(n, rng, p_zero=0.0)
        lens = np.zeros(n, np.int32)
        lens[4095], lens[4096] = 5, 6      # straddle the first edge
        lens[8191], lens[8192] = 1, 1      # and the second
        lens[12288:] = 6                   # a fully-dense segment
        return _masked(staging, lens), lens
    if case == "long_zero_gaps":
        n = 1 << 14
        staging, lens = _random_staging(n, rng, p_zero=0.0)
        keep = np.zeros(n, bool)
        keep[::3000] = True
        keep[n - 1] = True
        lens = np.where(keep, lens, 0).astype(np.int32)
        return _masked(staging, lens), lens
    if case == "all_six":
        return (rng.integers(0, 256, size=(6, 4096), dtype=np.uint8),
                np.full(4096, 6, np.int32))
    if case == "third_word_spill":
        # offsets 3, 9, 15, ...: every record at 3 mod 4 spills a byte
        # into a third word, the last one included
        staging = rng.integers(0, 256, size=(6, 2048), dtype=np.uint8)
        lens = np.full(2048, 6, np.int32)
        lens[0] = 3
        return _masked(staging, lens), lens
    if case == "all_one":
        staging, _ = _random_staging(4096, rng, p_zero=0.0)
        lens = np.ones(4096, np.int32)
        return _masked(staging, lens), lens
    if case == "empty":
        return np.zeros((6, 2048), np.uint8), np.zeros(2048, np.int32)
    if case.startswith("word_phase"):
        # a leading record of 1..4 bytes shifts every later offset
        # through each word phase
        lead = int(case[-1])
        staging, lens = _random_staging(2048, rng, p_zero=0.3)
        lens[0] = lead
        staging[:, 0] = [7, 8, 9, 10, 11, 12]
        return _masked(staging, lens), lens
    raise KeyError(case)


@functools.partial(jax.jit, static_argnames=("seg",))
def _wordsum_from_planes(staging, lens, seg):
    lo, hl = compact._record_words(staging, lens)
    return compact.compact_words6_wordsum(
        lo.view(jnp.uint32), (hl & 0xFFFF).view(jnp.uint32), lens,
        lens.shape[0] * 6, seg=seg, words_out=True)


@pytest.mark.parametrize("case,seg", [
    ("random", 0), ("random", 1024), ("random_small", 0),
    ("random_small", 256), ("random_wide", 20480), ("random_wide", 4096),
    ("segment_boundary", 0), ("long_zero_gaps", 0), ("all_six", 0),
    ("third_word_spill", 0), ("all_one", 0), ("empty", 0),
    ("word_phase_1", 0), ("word_phase_2", 0), ("word_phase_3", 0),
    ("word_phase_4", 0)])
def test_wordsum_record_lengths(case, seg):
    staging, lens = _lens_case(case)
    if case == "random_wide":  # n = 2^15 is ragged for seg 20480: pads
        staging, lens = _random_staging(1 << 15, np.random.default_rng(5))
    words, total = _wordsum_from_planes(
        jnp.asarray(staging), jnp.asarray(lens), seg)
    want = _records_from_planes(staging, lens)
    assert int(total) == len(want) == int(lens.sum())
    assert np.asarray(words).view(np.uint8)[: int(total)].tobytes() == want


@pytest.mark.parametrize("maker", ["mixed", "photo"])
def test_wordsum_full_encode_differential(maker):
    """Pipeline word staging -> word-sum compaction == the oracle."""
    w, h = 160, 96
    desc = fmt.StreamDesc(w, h, 4)
    img = getattr(testimages, maker)(w, h, 4, seed=11)
    px4 = pipeline.force_rgba(img, desc)
    n = px4.shape[0]
    cap = pipeline.bucket_size(n)
    padded = np.zeros((cap, 4), np.uint8)
    padded[:n] = px4
    ch = _stage_jit(jnp.asarray(padded), jnp.int32(n), form="words")
    words, total = jax.jit(
        lambda lo, hi, lens: compact.compact_words6_wordsum(
            lo, hi, lens, cap * 6, words_out=True))(ch.lo, ch.hi, ch.lens)
    got = (fmt.pack_header(desc)
           + np.asarray(words).view(np.uint8)[: int(total)].tobytes()
           + fmt.TRAILER)
    assert got == oracle.encode(img, desc)
