"""Profiling utilities: SOL models and the scaling-efficiency metric."""
import pytest

from qoi_tpu.utils import profiling


def test_scaling_efficiency():
    eff = profiling.scaling_efficiency({1: 100.0, 2: 180.0, 4: 300.0})
    assert eff[1] == pytest.approx(1.0)
    assert eff[2] == pytest.approx(0.9)
    assert eff[4] == pytest.approx(0.75)


def test_scaling_efficiency_needs_base():
    with pytest.raises(KeyError):
        profiling.scaling_efficiency({2: 10.0})
    with pytest.raises(ValueError):
        profiling.scaling_efficiency({1: 0.0, 2: 10.0})


def test_sol_models_positive():
    bw = profiling.peak_bytes_per_s("NVIDIA H100 80GB HBM3")
    e = profiling.encode_sol_model(8_294_400, 4, bw)
    d = profiling.decode_sol_model(8_294_400, 4, bw)
    assert e["sol_mpps"] > 0 and d["sol_mpps"] > 0
    assert e["bytes_moved"] > 8_294_400 * 4
    assert e["sol_seconds"] == pytest.approx(e["bytes_moved"] / bw)


def test_peak_table_h100():
    """The one listed kind returns its published rate (NVIDIA H100 SXM
    data sheet: 3.35 TB/s)."""
    assert profiling.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_peak_table_unknown_kind_raises(kind):
    """No rate is assumed for a device the table does not list."""
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        profiling.peak_bytes_per_s(kind)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and the helper
    sets nothing in code."""
    calls = []
    monkeypatch.setattr(profiling.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Variable unset: the cache sits at the fixed <checkout>/.jax_cache,
    which .gitignore lists."""
    import pathlib

    calls = []
    monkeypatch.setattr(profiling.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = pathlib.Path(__file__).resolve().parents[1]
    want = str(root / ".jax_cache")
    assert profiling.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_device_sync_time_blocks_on_every_output():
    """Each rep waits for all outputs (block_until_ready on the pytree)."""
    import jax.numpy as jnp

    seen = []

    class Leaf:
        def block_until_ready(self):
            seen.append(1)
            return self

    dt = profiling.device_sync_time(lambda: (Leaf(), [Leaf(), jnp.ones(2)]),
                                    reps=3)
    assert dt >= 0
    assert len(seen) == 2 * 4  # two custom leaves, warmup + 3 reps
