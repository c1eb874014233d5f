"""The streamed encoder's upload thread: a failure there must reach the
caller as an exception, never leave it blocked on the tile queue."""
import threading

import pytest

import qoi_tpu.format as fmt
from qoi_tpu.models import streamed
from qoi_tpu.utils import testimages


def test_streamed_producer_error_reaches_caller(monkeypatch):
    calls = {"n": 0}
    real_put = streamed.jax.device_put

    def failing_put(x, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:  # the second tile's upload fails
            raise MemoryError("simulated upload failure")
        return real_put(x, *a, **k)

    monkeypatch.setattr(streamed.jax, "device_put", failing_put)
    img = testimages.mixed(64, 40, 4)
    desc = fmt.StreamDesc(64, 40, 4)
    result = {}

    def run():
        try:
            streamed.encode(img, desc, tile_px=256)
        except Exception as e:  # recorded for the assertions below
            result["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive(), "streamed.encode hung on a dead producer"
    exc = result.get("exc")
    assert isinstance(exc, RuntimeError), exc
    assert "tile 1" in str(exc)
    assert isinstance(exc.__cause__, MemoryError)


def test_streamed_encode_still_exact_after_refactor():
    """The queue hand-off changes nothing for a healthy upload."""
    from qoi_tpu import oracle

    if not oracle.available():
        pytest.skip("oracle not built")
    img = testimages.mixed(50, 30, 4, seed=2)
    desc = fmt.StreamDesc(50, 30, 4)
    assert streamed.encode(img, desc, tile_px=256) == oracle.encode(img, desc)
