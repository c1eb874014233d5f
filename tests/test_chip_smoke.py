"""chip_smoke.py's phases at tiny sizes on the CPU.

The script itself refuses to run without a GPU (checked below); its
phase functions take the frame size as arguments, so the same checks —
every output against the oracle, every batch lane converged on the
device — run here on a few thousand pixels. The GPU run is
`python chip_smoke.py` (one card) and `python chip_smoke.py --chips 4`.
"""

import pytest

import chip_smoke
from qoi_tpu import oracle

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle not built")


def test_main_refuses_without_gpu(capsys):
    """No GPU: non-zero exit and no result line, never a CPU run."""
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "needs a GPU" in err


def test_phase_single_tiny(capsys):
    chip_smoke.phase_single(64, 32)
    out = capsys.readouterr().out
    assert "mixed RGBA 64x32: encode and decode oracle-exact" in out
    assert "photo RGB 64x32: encode and decode oracle-exact" in out
    assert "memory_analysis decode_v3._decode_device" in out


def test_phase_batch_tiny(capsys):
    """2 + 2 streams in one shape group with sub_batch=2: the chunked
    decode_group program, as at full size."""
    chip_smoke.phase_batch(64, 48, n_encode=2, n_decode_each=2, sub_batch=2,
                           n_unique=1)
    out = capsys.readouterr().out
    assert "all 4 lanes converged on the device" in out
    assert "memory_analysis decode_v3._decode_device_batch_chunked" in out


def test_phase_streamed_tiny(monkeypatch, capsys):
    """A lowered threshold sends a small frame through models/streamed."""
    import qoi_tpu
    from qoi_tpu.config import EngineConfig

    monkeypatch.setattr(qoi_tpu, "STREAM_THRESHOLD_PX", 1000)
    chip_smoke.phase_streamed(64, 40, config=EngineConfig(stream_tile_px=1024))
    assert "streamed 64x40" in capsys.readouterr().out


def test_phase_streamed_checks_threshold():
    """Below the threshold the phase would not test streaming: it fails."""
    with pytest.raises(chip_smoke.SmokeFailure, match="streaming threshold"):
        chip_smoke.phase_streamed(64, 40)


def test_phase_hostile_tiny(capsys):
    chip_smoke.phase_hostile(64, 32)
    assert "ladder decode oracle-exact" in capsys.readouterr().out


def test_phase_four_cards_on_virtual_mesh(capsys):
    """The four-card phase on four of the suite's virtual CPU devices."""
    chip_smoke.phase_four_cards(64, 40, 4)
    out = capsys.readouterr().out
    assert "every shard converged, oracle-exact" in out
    assert "identical to the one-device encode" in out


def test_pack_streams_rejects_mixed_groups():
    """A convergence check on a different program than decode_batch ran
    would prove nothing: streams of two shape groups are refused."""
    from qoi_tpu import format as fmt
    from qoi_tpu.utils import testimages

    small = oracle.encode(testimages.flat(8, 8, 4), fmt.StreamDesc(8, 8, 4))
    big = oracle.encode(testimages.noise(128, 128, 4),
                        fmt.StreamDesc(128, 128, 4))
    with pytest.raises(chip_smoke.SmokeFailure, match="shape groups"):
        chip_smoke._pack_streams([small, big])
