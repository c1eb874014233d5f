"""Tracing / profiling / speed-of-light accounting (SURVEY §5.1).

The reference's only instrumentation is a nanosecond timer + warmup macro
(qoibench.c:33-88, 362-376). Here:

- `trace(path)` wraps a region in a `jax.profiler` trace (viewable in
  XProf/TensorBoard/Perfetto);
- `annotate(name)` adds named scopes so pipeline stages are attributable
  in profiles;
- `enable_compile_cache()` turns on JAX's persistent compilation cache at
  the one place this repository keeps it;
- `device_sync_time(fn)` times a device callable: best of several reps,
  each ending in `jax.block_until_ready` on every output;
- `gpu_cards()` reads each card's name and power limit, which go beside
  every number measured on it;
- `peak_bytes_per_s(kind)` is the published memory bandwidth of a device
  kind, and `encode_sol_model` / `decode_sol_model` turn it into the
  bytes-moved speed-of-light bound, the denominator for "fraction of
  roofline" reporting.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import jax

#: the repository checkout: the compile cache lives at a fixed path in it
_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region into `logdir` (XProf format)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope for pipeline stages (shows up in device profiles)."""
    return jax.named_scope(name)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to `<checkout>/.jax_cache`
    (listed in .gitignore): a fixed path, because the path is part of the
    cache key and a per-process or temporary directory would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_sync_time(fn: Callable[[], object], reps: int = 5) -> float:
    """Best-of-reps seconds for `fn`, each rep ending when every output
    leaf is ready on the device. One untimed call first absorbs
    compilation."""
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def gpu_cards() -> List[Tuple[str, str]]:
    """(name, power limit) of every GPU, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them. A card below its maximum power limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [tuple(f.strip() for f in line.split(",", 1))
            for line in out.strip().splitlines()]


# -- speed-of-light models (bytes moved at minimum, memory-bandwidth bound) --

#: published peak device-memory bandwidth, bytes/s, keyed by
#: jax.Device.device_kind. H100 SXM: 3.35 TB/s (NVIDIA H100 data sheet).
#: A kind missing here is an error, never a default.
PEAK_BYTES_PER_S: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of `device_kind`; raises KeyError for a
    kind the table does not list."""
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to PEAK_BYTES_PER_S with its "
            f"source") from None


def encode_sol_model(n_px: int, channels: int, bw: float,
                     rate: float = 0.45) -> Dict[str, float]:
    """Minimum-traffic model for encode at `bw` bytes/s: read pixels once
    (4 B/px after RGBA forcing), write staging once and read it back for
    compaction (~6 B/px worst, rate-dependent typical), write the stream
    (~rate * channels B/px)."""
    read_px = 4 * n_px
    staging = 2 * 6 * n_px  # write + read
    out = rate * channels * n_px
    total = read_px + staging + out
    return {
        "bytes_moved": total,
        "sol_seconds": total / bw,
        "sol_mpps": (n_px / 1e6) / (total / bw),
    }


def decode_sol_model(n_px: int, channels: int, bw: float,
                     rate: float = 0.45) -> Dict[str, float]:
    """Minimum-traffic model for decode at `bw` bytes/s: read the stream,
    tokenize (touch bytes ~2x), resolve + write pixels (4 B/px)."""
    stream = rate * channels * n_px
    total = 3 * stream + 4 * n_px
    return {
        "bytes_moved": total,
        "sol_seconds": total / bw,
        "sol_mpps": (n_px / 1e6) / (total / bw),
    }


def scaling_efficiency(mpps_by_shards):
    """BASELINE's scaling metric: efficiency[s] = Mpx/s at s shards
    divided by (s x Mpx/s at 1 shard). mpps_by_shards: {shard_count:
    mpps}. Returns {shard_count: efficiency in [0, ~1]}; requires the
    1-shard entry."""
    base = mpps_by_shards[1]
    if base <= 0:
        raise ValueError("1-shard throughput must be positive")
    return {s: v / (s * base) for s, v in sorted(mpps_by_shards.items())}
