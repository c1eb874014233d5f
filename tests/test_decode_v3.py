"""Blocked symbolic decoder (v3) vs the C++ oracle: the same coverage
classes as v1/v2 plus cases specific to the v3 formulation — deep INDEX
chains (which v3 resolves in one pass, no per-hop fixpoint) and the
alpha-through-INDEX hash-estimate correction."""
import numpy as np
import pytest

import jax.numpy as jnp

import qoi_tpu.format as fmt
from qoi_tpu import oracle
from qoi_tpu.models import decode_pipeline as v1, decode_v3
from qoi_tpu.utils import testimages

pytestmark = pytest.mark.skipif(not oracle.available(), reason="oracle not built")


def _roundtrip(img: np.ndarray) -> None:
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    got, gdesc = decode_v3.decode(stream)
    want, wdesc = oracle.decode(stream)
    assert gdesc == wdesc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(testimages.edge_case_suite(4)))
def test_v3_edge_cases_rgba(name):
    _roundtrip(testimages.edge_case_suite(4)[name])


@pytest.mark.parametrize("name", ["gradient", "palette", "mixed", "noise_small"])
def test_v3_edge_cases_rgb(name):
    _roundtrip(testimages.edge_case_suite(3)[name])


def test_v3_deep_index_chains_one_round():
    """A long palette cycle builds INDEX->INDEX reference chains far deeper
    than any fixpoint cap; the symbolic scan must resolve them in ONE
    round (the convergence certificate is over written slots, not values)."""
    img = testimages.palette(512, 16, 4, colors=12, seed=13)
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    chunks = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    cap = v1.bucket_size(len(chunks))
    pad = np.zeros((cap,), np.uint8)
    pad[: len(chunks)] = chunks
    px32, conv, rounds = decode_v3._decode_device(
        jnp.asarray(pad), np.int32(len(stream) - 22), v1.bucket_size(w * h))
    assert bool(conv) and int(rounds) == 1
    got = decode_v3.unpack_px32(np.asarray(px32))[: w * h]
    want, _ = oracle.decode(stream)
    np.testing.assert_array_equal(got.reshape(h, w, 4), want)


def test_v3_mixed_class_converges():
    """The varying-alpha `mixed` class converges in a couple of rounds
    (round-3 measurement: 1-2 mismatches per stream, fixed in one
    correction round) — it must NOT take the fallback ladder."""
    img = testimages.mixed(256, 128, 4, seed=3)
    h, w, ch = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, ch))
    chunks = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    cap = v1.bucket_size(len(chunks))
    pad = np.zeros((cap,), np.uint8)
    pad[: len(chunks)] = chunks
    px32, conv, rounds = decode_v3._decode_device(
        jnp.asarray(pad), np.int32(len(stream) - 22), v1.bucket_size(w * h))
    assert bool(conv) and int(rounds) <= 3
    got = decode_v3.unpack_px32(np.asarray(px32))[: w * h]
    want, _ = oracle.decode(stream)
    np.testing.assert_array_equal(got.reshape(h, w, 4), want)


def test_v3_palette_alpha_converges_anchored():
    """`palette_alpha` (dense INDEX chunks loading random alphas) was the
    adversarial class for the naive w' = hash(px) fixpoint (error chains
    grew with stream length; it could NEVER converge). The round-3
    anchored next-w estimate (decode_v3._anchored_w) re-anchors at every
    INDEX/RGB/RGBA chunk, so every canonical content class converges in
    a few rounds — this class included."""
    img = testimages.palette_alpha(128, 96, colors=40, seed=7)
    h, w, _ = img.shape
    stream = oracle.encode(img, fmt.StreamDesc(w, h, 4))
    chunks = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    cap = v1.bucket_size(len(chunks))
    pad = np.zeros((cap,), np.uint8)
    pad[: len(chunks)] = chunks
    px32, conv, rounds = decode_v3._decode_device(
        jnp.asarray(pad), np.int32(len(stream) - 22), v1.bucket_size(w * h))
    assert bool(conv) and int(rounds) <= 4
    got = decode_v3.unpack_px32(np.asarray(px32))[: w * h]
    want, _ = oracle.decode(stream)
    np.testing.assert_array_equal(got.reshape(h, w, 4), want)


def test_v3_index_alpha_then_rgb_fixpoint():
    """INDEX restoring an old alpha followed by RGB breaks the optimistic
    written-slot estimate; the hash fixpoint must correct it."""
    px = np.zeros((64, 4), np.uint8)
    px[:, 3] = 255
    px[0] = (1, 1, 1, 50)
    px[1] = (200, 9, 9, 50)
    px[2] = (3, 3, 3, 99)
    px[3] = (1, 1, 1, 50)     # INDEX hit -> alpha 50 != last RGBA literal
    px[4] = (90, 90, 90, 50)  # RGB whose hash uses INDEX-carried alpha
    px[5:] = px[4]
    _roundtrip(px.reshape(1, 64, 4))


def test_bucket_size_fine():
    """Quarter-pow2 buckets: minimal candidate >= n, divisible by 2^17,
    <= 12.5% padding; pow2 below 2^20 (keeps small test streams on the
    coarse buckets — 4x finer buckets quadruple suite compiles)."""
    from qoi_tpu.models.decode_pipeline import bucket_size_fine

    assert bucket_size_fine(1000) == 1024
    assert bucket_size_fine(70000) == 1 << 17
    assert bucket_size_fine(1 << 20) == 1 << 20
    for n in ((1 << 20) + 1, 1500000, 14047085, 16777216, 16777217):
        b = bucket_size_fine(n)
        assert b >= n and b % (1 << 17) == 0
        assert b <= n * 1.25 + (1 << 17)


@pytest.mark.slow
def test_v3_decode_fine_bucket_stream():
    """Public decode through a quarter-pow2 stream bucket (stream >
    2^20 bytes exercises the fine-bucket scan shapes: m = odd * 2^18)."""
    img = testimages.noise(640, 512, 4)  # ~1.3 MB stream, incompressible
    stream = oracle.encode(img, fmt.StreamDesc(640, 512, 4))
    assert len(stream) > (1 << 20)
    got, _ = decode_v3.decode(stream)
    want, _ = oracle.decode(stream)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["photo", "mixed", "palette_alpha",
                                  "runs"])
def test_decode_core_expand_matches_oracle(case):
    """The decoder's per-byte (pix_off, px) records through run expansion
    (ops/expand) must be the oracle's pixels for every content class,
    including the truncation-tolerant tail past the last chunk."""
    from qoi_tpu.ops import expand

    w, h = 256, 128
    img = {"photo": lambda: testimages.photo(w, h, 4),
           "mixed": lambda: testimages.mixed(w, h, 4),
           "palette_alpha": lambda: testimages.palette_alpha(w, h),
           "runs": lambda: testimages.runs_with_caps(w, h, 4)}[case]()
    stream = oracle.encode(img, fmt.StreamDesc(w, h, 4))
    chunks = np.frombuffer(stream, np.uint8)[fmt.HEADER_SIZE:]
    cap = v1.bucket_size(len(chunks), 4096)
    pad = np.zeros((cap,), np.uint8)
    pad[: len(chunks)] = chunks
    npc = v1.bucket_size(w * h)
    px, starts, npix, pix_off, conv, _, _ = decode_v3._decode_core(
        jnp.asarray(pad), jnp.int32(len(stream) - 22))
    assert bool(conv)
    got = decode_v3.unpack_px32(np.asarray(
        expand.expand_px(pix_off, px, npc)))
    want, _ = oracle.decode(stream)
    np.testing.assert_array_equal(got[: w * h].reshape(h, w, 4), want)
    # past the image the plane repeats the last pixel (qoi.h:544)
    assert (got[w * h:] == got[w * h - 1]).all()


def test_v3_truncation_and_channel_forcing():
    img = testimages.mixed(40, 30, 4)
    full = oracle.encode(img, fmt.StreamDesc(40, 30, 4))
    cut = full[: fmt.HEADER_SIZE + 11] + fmt.TRAILER
    got, _ = decode_v3.decode(cut)
    want, _ = oracle.decode(cut)
    np.testing.assert_array_equal(got, want)
    for ch in (0, 3, 4):
        got, _ = decode_v3.decode(full, ch)
        want, _ = oracle.decode(full, ch)
        np.testing.assert_array_equal(got, want)


def test_v3_noncanonical_streams():
    """INDEX into unwritten slots; RUN at stream start (seed table store,
    qoi.h:577)."""
    for body in (
        bytes([fmt.OP_INDEX | 5, fmt.OP_INDEX | 0, fmt.OP_INDEX | 63,
               fmt.OP_RGB, 9, 9, 9]),
        # RUN first: stores the seed at slot 53; INDEX 53 then reads it
        bytes([fmt.OP_RUN | 1, fmt.OP_RGB, 7, 7, 7, fmt.OP_INDEX | 53]),
    ):
        n = 4
        data = fmt.pack_header(fmt.StreamDesc(n, 1, 4)) + body + fmt.TRAILER
        got, _ = decode_v3.decode(data)
        want, _ = oracle.decode(data)
        np.testing.assert_array_equal(got, want)


def test_v3_batch_group():
    imgs = [testimages.mixed(48, 32, 4, seed=i) for i in range(3)]
    streams = [oracle.encode(im, fmt.StreamDesc(48, 32, 4)) for im in imgs]
    cap = v1.bucket_size(max(len(s) - fmt.HEADER_SIZE for s in streams))
    data = np.zeros((3, cap), np.uint8)
    clens = np.zeros((3,), np.int32)
    for i, s in enumerate(streams):
        body = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        data[i, : len(body)] = body
        clens[i] = len(s) - 22
    px32, conv = decode_v3.decode_group(
        jnp.asarray(data), jnp.asarray(clens), v1.bucket_size(48 * 32))
    assert bool(np.all(np.asarray(conv)))
    for i, im in enumerate(imgs):
        got = decode_v3.unpack_px32(np.asarray(px32[i]))[: 48 * 32]
        np.testing.assert_array_equal(got.reshape(32, 48, 4), im)


def test_v3_batch_chunked_matches_flat():
    """The lax.map-of-sub-batches program (the large-batch bench shape)
    must produce exactly the flat vmap's results."""
    imgs = [testimages.mixed(40, 24, 4, seed=10 + i) for i in range(4)]
    streams = [oracle.encode(im, fmt.StreamDesc(40, 24, 4)) for im in imgs]
    cap = v1.bucket_size(max(len(s) - fmt.HEADER_SIZE for s in streams))
    data = np.zeros((4, cap), np.uint8)
    clens = np.zeros((4,), np.int32)
    for i, s in enumerate(streams):
        body = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        data[i, : len(body)] = body
        clens[i] = len(s) - 22
    npc = v1.bucket_size(40 * 24)
    flat = decode_v3._decode_device_batch(
        jnp.asarray(data), jnp.asarray(clens), npc)
    chunked = decode_v3._decode_device_batch_chunked(
        jnp.asarray(data), jnp.asarray(clens), npc, sub_batch=2)
    for a, b in zip(flat, chunked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_v3_random_roundtrips():
    rng = np.random.default_rng(7)
    for t in range(8):
        w = int(rng.integers(1, 90))
        h = int(rng.integers(1, 40))
        ch = int(rng.choice([3, 4]))
        img = testimages.palette(w, h, ch, colors=int(rng.integers(2, 20)),
                                 seed=int(rng.integers(1 << 30)))
        _roundtrip(img)


@pytest.mark.parametrize("entry", ["seed", "chained"])
def test_resolve_vector_apply_matches_scan(entry):
    """The vectorized pass-3 replacement (`_apply_symbolic` over pass-1's
    symbolic per-position px entries) must produce byte-identical px and
    exit states to the original numeric re-scan, for every content class
    and under tiled/streamed entry-state chaining."""
    cases = [
        testimages.photo(160, 96, 4, seed=5),
        testimages.mixed(160, 96, 4, seed=3),
        testimages.palette_alpha(160, 96, colors=40, seed=7),
        testimages.runs_with_caps(160, 96, 4),
        testimages.alpha_toggle(160, 96),
        testimages.noise(64, 48, 4, seed=1),
    ]
    rng = np.random.default_rng(11)
    e65 = (None if entry == "seed" else jnp.asarray(
        rng.integers(0, 1 << 32, 65, dtype=np.uint64).astype(np.uint32)))
    for img in cases:
        h, w, _ = img.shape
        s = oracle.encode(img, fmt.StreamDesc(w, h, 4))
        raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        clen = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
        cap = v1.bucket_size(len(raw))
        d = np.zeros(cap, np.uint8)
        d[:len(raw)] = raw
        d = jnp.asarray(d)
        starts, cls, r6, d32, lit32, _ = decode_v3._fields(
            d, jnp.int32(clen))
        epx = None if e65 is None else e65[0]
        w0 = jnp.where(
            starts, decode_v3._initial_w(cls, r6, d32, lit32, epx), 0)
        b = decode_v3._scan_block_len(cap)
        px_s, ex_s = decode_v3._resolve(cls, r6, w0, d32, lit32, cap, b,
                                        entry65=e65, apply="scan")
        px_v, ex_v = decode_v3._resolve(cls, r6, w0, d32, lit32, cap, b,
                                        entry65=e65, apply="vector")
        np.testing.assert_array_equal(np.asarray(px_s), np.asarray(px_v))
        np.testing.assert_array_equal(np.asarray(ex_s), np.asarray(ex_v))


def test_v3_group_auto_chunks_large_batches():
    """decode_group routes batches larger than sub_batch through the
    chunked one-program form (the bench shape) with identical pixels."""
    imgs = [testimages.mixed(40, 24, 4, seed=20 + i) for i in range(2)]
    streams = [oracle.encode(im, fmt.StreamDesc(40, 24, 4)) for im in imgs]
    cap = v1.bucket_size(max(len(s) - fmt.HEADER_SIZE for s in streams))
    data = np.zeros((2, cap), np.uint8)
    clens = np.zeros((2,), np.int32)
    for i, s in enumerate(streams):
        body = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        data[i, : len(body)] = body
        clens[i] = len(s) - 22
    npc = v1.bucket_size(40 * 24)
    d8 = jnp.concatenate([jnp.asarray(data)] * 4, axis=0)
    c8 = jnp.asarray(np.concatenate([clens] * 4))
    px32, conv = decode_v3.decode_group(d8, c8, npc, sub_batch=2)
    assert px32.shape[0] == 8 and bool(np.all(np.asarray(conv)))
    for i in range(8):
        got = decode_v3.unpack_px32(np.asarray(px32[i]))[: 40 * 24]
        np.testing.assert_array_equal(
            got.reshape(24, 40, 4), imgs[i % 2])


@pytest.mark.slow
def test_surgical_second_round_large_mixed():
    """The surgical round 2 (r5) engages only at nbk >= 256 (~2 MB
    streams): a large alpha-toggling mixed image must converge in
    exactly 2 rounds through the dirty-block rebuild + entry-delta
    apply, pixel-identically — the full certificate is the correctness
    anchor (reference qoi.h:488-587)."""
    img = testimages.mixed(1280, 960, 4, seed=9)
    desc = fmt.StreamDesc(1280, 960, 4)
    s = oracle.encode(img, desc)
    raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
    clen = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    cap = v1.bucket_size_fine(len(raw))
    padded = np.zeros((cap,), np.uint8)
    padded[: len(raw)] = raw
    b = decode_v3._scan_block_len(cap)
    assert cap // b >= 256, "stream too small to engage the surgical round"
    out, conv, rounds = decode_v3._decode_device(
        jnp.asarray(padded), jnp.int32(clen),
        v1.bucket_size(desc.num_pixels))
    assert bool(conv) and int(rounds) == 2
    got = decode_v3.unpack_px32(np.asarray(out))[: desc.num_pixels]
    np.testing.assert_array_equal(got.reshape(img.shape), img)


@pytest.mark.slow
def test_surgical_overflow_falls_to_full_rounds():
    """Error sites in more than K=64 blocks must overflow the surgical
    cap and converge through the unchanged full-round loop (or ladder),
    still pixel-exact: palette_alpha at a size with nbk >= 256 has
    INDEX-alpha errors everywhere."""
    img = testimages.palette_alpha(1280, 960, colors=48, seed=5)
    desc = fmt.StreamDesc(1280, 960, 4)
    s = oracle.encode(img, desc)
    got, _ = decode_v3.decode(s)
    np.testing.assert_array_equal(got, img)
