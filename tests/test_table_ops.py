"""ops/table.py unit tests vs a direct numpy replay (SURVEY §2.2 property)."""
import numpy as np
import pytest

import jax.numpy as jnp

from qoi_tpu.ops import table


def _np_replay(keys, vals, write, tbl0=None, wr0=None, qkeys=None):
    n = len(keys)
    t = np.zeros(64, np.uint32) if tbl0 is None else np.where(wr0, tbl0, 0).astype(np.uint32)
    w = np.zeros(64, bool) if wr0 is None else wr0.copy()
    before = np.zeros(n, np.uint32)
    hit = np.zeros(n, bool)
    qk = keys if qkeys is None else qkeys
    for i in range(n):
        before[i] = t[qk[i]]
        hit[i] = t[keys[i]] == vals[i]
        if write[i]:
            t[keys[i]] = vals[i]
            w[keys[i]] = True
    return before, hit, np.where(w, t, 0), w


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096])
def test_table_hit_matches_replay(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 64, n).astype(np.int32)
    vals = (rng.integers(0, 6, n) * 999983).astype(np.uint32)  # collisions
    write = rng.integers(0, 2, n).astype(bool)
    _, want_hit, want_t, want_w = _np_replay(keys, vals, write)
    hit, (ft, fw) = table.table_hit(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(write))
    np.testing.assert_array_equal(np.asarray(hit), want_hit)
    np.testing.assert_array_equal(np.asarray(ft), want_t)
    np.testing.assert_array_equal(np.asarray(fw), want_w)


def test_table_hit_incoming_state():
    rng = np.random.default_rng(7)
    n = 500
    keys = rng.integers(0, 64, n).astype(np.int32)
    vals = (rng.integers(0, 4, n) * 777).astype(np.uint32)
    write = rng.integers(0, 2, n).astype(bool)
    tbl0 = rng.integers(0, 2**32, 64, dtype=np.uint32)
    wr0 = rng.integers(0, 2, 64).astype(bool)
    # make some incoming entries hittable
    for i in range(0, n, 17):
        s = keys[i]
        if wr0[s]:
            vals[i] = tbl0[s]
    _, want_hit, want_t, want_w = _np_replay(keys, vals, write, tbl0, wr0)
    hit, (ft, fw) = table.table_hit(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(write),
        incoming=(jnp.asarray(tbl0), jnp.asarray(wr0)))
    np.testing.assert_array_equal(np.asarray(hit), want_hit)
    np.testing.assert_array_equal(np.asarray(ft), want_t)
    np.testing.assert_array_equal(np.asarray(fw), want_w)


def test_table_hit_zero_entry_semantics():
    """Unwritten slots hold (0,0,0,0): packed 0 hits, others miss."""
    keys = np.array([0, 5, 0], np.int32)
    vals = np.array([0, 0, 0], np.uint32)
    write = np.array([False, False, True])
    hit, _ = table.table_hit(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(write))
    np.testing.assert_array_equal(np.asarray(hit), [True, True, True])


@pytest.mark.parametrize("n", [100, 2000])
def test_table_replay_query_keys(n):
    rng = np.random.default_rng(n + 1)
    keys = rng.integers(0, 64, n).astype(np.int32)
    qkeys = rng.integers(0, 64, n).astype(np.int32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    write = rng.integers(0, 2, n).astype(bool)
    want_before, _, want_t, want_w = _np_replay(keys, vals, write, qkeys=qkeys)
    before, (ft, fw) = table.table_replay(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(write),
        query_keys=jnp.asarray(qkeys))
    np.testing.assert_array_equal(np.asarray(before), want_before)
    np.testing.assert_array_equal(np.asarray(ft), want_t)
    np.testing.assert_array_equal(np.asarray(fw), want_w)


# -- the QOI hash as elementwise multiply-adds (never a dot) ---------------

def _np_hash(px):
    p = px.astype(np.int64)
    return (p[..., 0] * 3 + p[..., 1] * 5 + p[..., 2] * 7
            + p[..., 3] * 11) % 64


@pytest.mark.parametrize("which", ["table", "scan_codec"])
def test_hash_exhaustive_extremes(which):
    """Every hash implementation equals (3r+5g+7b+11a) mod 64 on all
    pixels built from the extreme channel values, where the unmasked sum
    reaches 255*26 = 6630 (13 bits, more than a TF32 product keeps)."""
    from qoi_tpu.models import scan_codec

    vals = np.array([0, 1, 2, 63, 64, 127, 128, 200, 254, 255], np.uint8)
    px = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"),
                  axis=-1).reshape(-1, 4)
    fn = table.hash64 if which == "table" else scan_codec._hash64
    got = np.asarray(fn(jnp.asarray(px)))
    np.testing.assert_array_equal(got, _np_hash(px))
    assert int(np.asarray(px.astype(np.int32) @ np.array([3, 5, 7, 11]))
               .max()) == 6630


def test_hash_traces_no_dot():
    """The hash lowers to elementwise integer ops only: no dot_general
    that a matmul precision setting could route through tensor cores."""
    import jax

    jaxpr = jax.make_jaxpr(table.hash64)(jnp.zeros((16, 4), jnp.uint8))
    prims = {e.primitive.name for e in jaxpr.jaxpr.eqns}
    assert "dot_general" not in prims
    assert "mul" in prims


def test_hash_matches_oracle_on_index_heavy_image():
    """An image whose INDEX decisions depend on high-sum hashes (bright,
    opaque and translucent palettes revisited out of order) encodes
    byte-identically to the C++ oracle."""
    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import pipeline

    if not oracle.available():
        pytest.skip("oracle not built")
    rng = np.random.default_rng(3)
    pal = rng.integers(200, 256, size=(48, 4), dtype=np.uint8)
    pal[::3, 3] = 255
    img = pal[rng.integers(0, 48, size=(24, 40))]
    desc = fmt.StreamDesc(40, 24, 4)
    assert pipeline.encode(img, desc) == oracle.encode(img, desc)
