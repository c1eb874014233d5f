"""Reproducible trust anchor: differential the C++ oracle against the
ACTUAL reference implementation (/root/reference/qoi.h, compiled into a
scratch shared library at test time — the reference tree itself stays
read-only and no reference code enters the repo).

This closes the verification chain: device engines are tested byte-exact
against the C++ oracle everywhere else; here the oracle itself is
re-validated against qoi_encode/qoi_decode from qoi.h:356/qoi.h:488 on
the edge-case suite, random images, header rejection, and truncation.
"""
import ctypes
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

from qoi_tpu import format as fmt
from qoi_tpu import oracle
from qoi_tpu.utils import testimages

_REF = pathlib.Path("/root/reference/qoi.h")

pytestmark = pytest.mark.skipif(
    not (_REF.exists() and shutil.which("cc") and oracle.available()),
    reason="needs /root/reference/qoi.h, a C compiler, and the C++ oracle")

_HARNESS = r"""
#define QOI_IMPLEMENTATION
#define QOI_NO_STDIO
#include "qoi.h"

void *ref_encode(const void *data, int w, int h, unsigned char channels,
                 unsigned char colorspace, int *out_len) {
    qoi_desc d = {(unsigned)w, (unsigned)h, channels, colorspace};
    return qoi_encode(data, &d, out_len);
}

void *ref_decode(const void *data, int size, int channels,
                 unsigned int *out_desc) {
    qoi_desc d;
    void *px = qoi_decode(data, size, &d, channels);
    out_desc[0] = d.width;
    out_desc[1] = d.height;
    out_desc[2] = d.channels;
    out_desc[3] = d.colorspace;
    return px;
}

void ref_free(void *p) { QOI_FREE(p); }
"""


@pytest.fixture(scope="module")
def ref():
    """Compile qoi.h into a scratch .so and bind it via ctypes."""
    tmp = tempfile.mkdtemp(prefix="qoi_ref_")
    src = pathlib.Path(tmp) / "harness.c"
    so = pathlib.Path(tmp) / "libqoiref.so"
    src.write_text(_HARNESS)
    subprocess.run(
        ["cc", "-O2", "-fPIC", "-shared", "-I", str(_REF.parent),
         str(src), "-o", str(so)],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ref_encode.restype = ctypes.c_void_p
    lib.ref_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_ubyte, ctypes.c_ubyte,
                               ctypes.POINTER(ctypes.c_int)]
    lib.ref_decode.restype = ctypes.c_void_p
    lib.ref_decode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint)]
    lib.ref_free.argtypes = [ctypes.c_void_p]
    yield lib
    shutil.rmtree(tmp, ignore_errors=True)


def _ref_encode(lib, img, desc):
    buf = np.ascontiguousarray(img).tobytes()
    out_len = ctypes.c_int(0)
    p = lib.ref_encode(buf, desc.width, desc.height, desc.channels,
                       desc.colorspace, ctypes.byref(out_len))
    if not p:
        return None
    try:
        return ctypes.string_at(p, out_len.value)
    finally:
        lib.ref_free(p)


def _ref_decode(lib, stream, channels=0):
    d = (ctypes.c_uint * 4)()
    p = lib.ref_decode(stream, len(stream), channels, d)
    if not p:
        return None, None
    ch = channels or d[2]
    try:
        px = np.frombuffer(
            ctypes.string_at(p, d[0] * d[1] * ch), np.uint8).copy()
    finally:
        lib.ref_free(p)
    return px.reshape(d[1], d[0], ch), fmt.StreamDesc(d[0], d[1], d[2], d[3])


@pytest.mark.parametrize("ch", [3, 4])
def test_encode_byte_identical(ref, ch):
    for name, img in testimages.edge_case_suite(ch).items():
        h, w = img.shape[:2]
        desc = fmt.StreamDesc(w, h, ch)
        assert oracle.encode(img, desc) == _ref_encode(ref, img, desc), name


@pytest.mark.parametrize("seed", range(8))
def test_encode_random_images(ref, seed):
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(1, 97)), int(rng.integers(1, 97))
    ch = int(rng.choice([3, 4]))
    img = rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)
    # salt with runs and repeats to hit RUN/INDEX ops
    if h > 4:
        img[2:4] = img[1]
    desc = fmt.StreamDesc(w, h, ch)
    assert oracle.encode(img, desc) == _ref_encode(ref, img, desc)


@pytest.mark.parametrize("force", [0, 3, 4])
def test_decode_pixel_identical(ref, force):
    for name, img in testimages.edge_case_suite(4).items():
        h, w = img.shape[:2]
        stream = oracle.encode(img, fmt.StreamDesc(w, h, 4))
        want, wdesc = _ref_decode(ref, stream, force)
        got, gdesc = oracle.decode(stream, force)
        assert np.array_equal(got, want), name
        assert (gdesc.width, gdesc.height, gdesc.channels) == (
            wdesc.width, wdesc.height, wdesc.channels), name


def _oracle_decode_or_none(stream, channels=0):
    try:
        return oracle.decode(stream, channels)
    except ValueError:
        return None, None


def test_truncation_parity(ref):
    img = testimages.mixed(24, 24, 4)
    stream = oracle.encode(img, fmt.StreamDesc(24, 24, 4))
    for cut in [fmt.HEADER_SIZE + 8, len(stream) // 2, len(stream) - 9]:
        trunc = stream[:cut]
        want, _ = _ref_decode(ref, trunc)
        got, _ = _oracle_decode_or_none(trunc)
        if want is None:
            assert got is None, cut
        else:
            assert np.array_equal(got, want), cut


def test_reject_parity_headers(ref):
    """Malformed headers must be rejected (or not) identically —
    including the near-cap integer-division case (qoi.h:369,518)."""
    cases = []
    # valid base header for a 4x4 image, then mutate fields
    base = bytearray(oracle.encode(
        testimages.flat(4, 4, 4), fmt.StreamDesc(4, 4, 4)))
    cases.append(bytes(base))
    bad_magic = bytearray(base); bad_magic[0] = 0x51
    cases.append(bytes(bad_magic))
    zero_w = bytearray(base); zero_w[4:8] = b"\x00\x00\x00\x00"
    cases.append(bytes(zero_w))
    bad_ch = bytearray(base); bad_ch[12] = 5
    cases.append(bytes(bad_ch))
    bad_cs = bytearray(base); bad_cs[13] = 2
    cases.append(bytes(bad_cs))
    # near the 400M pixel cap: w=3, h=133333333 => 399,999,999 px is
    # REJECTED by the reference (h >= PIXELS_MAX // w with w=3)
    near_cap = bytearray(base)
    near_cap[4:8] = (3).to_bytes(4, "big")
    near_cap[8:12] = (133333333).to_bytes(4, "big")
    cases.append(bytes(near_cap))
    cases.append(b"qoif")  # too short

    for i, stream in enumerate(cases):
        want, _ = _ref_decode(ref, stream)
        got, _ = _oracle_decode_or_none(stream)
        assert (got is None) == (want is None), f"case {i}"
