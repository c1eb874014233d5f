"""Full-corpus conformance gate (slow tier).

Builds the complete ~300-image synthetic conformance corpus
(tools/make_corpus.py — the stand-in for the reference's ~2,800-image
qoi_benchmark_suite, reference README.md:19) and runs the device-engine
roundtrip over every image with BOTH gates:

  * decode(encode(img)) pixel-identical to the source, and
  * every encoded stream byte-identical to the C++ oracle.

The bar: verify_failures == 0 at >= 300 images, including hash-collision palettes, worst-case ~5 B/px noise,
1xN / Nx1 extremes and >= 16 Mpx members.
"""
import pathlib
import sys

import pytest

from qoi_tpu import corpus, oracle

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

pytestmark = [
    pytest.mark.skipif(not oracle.available(), reason="oracle not built"),
    pytest.mark.slow,
]


def test_full_corpus_roundtrip_oracle_exact(tmp_path_factory):
    from tools import make_corpus

    root = tmp_path_factory.mktemp("qoi_corpus_full")
    n = make_corpus.build(root)
    assert n >= 300
    c = corpus.run_job(root, "roundtrip", oracle_verify=True,
                       progress=lambda m: None)
    assert c.images == n
    assert c.verify_failures == 0
    assert c.pixels >= 150_000_000
