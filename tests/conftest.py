"""Test config: force JAX onto a virtual 8-device CPU platform.

Multi-device code paths are exercised via
`xla_force_host_platform_device_count` (SURVEY.md §4); the same code runs
unmodified on several GPUs. What only a GPU can show (compiled device
code, its memory and its times) is checked by `python chip_smoke.py`,
not by this suite.

CPU is forced through `jax.config` as well as the environment, so a
machine whose JAX defaults to a GPU still runs the suite on the CPU.
"""
import os

# NO JAX_COMPILATION_CACHE_DIR here: the suite must not read or write the
# persistent cache (see the note below the jax import) — these lines once
# set it and quietly contradicted that note.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NO persistent compile cache for the forced-CPU suite: XLA:CPU AOT
# entries record the compile machine's CPU features, and loading them on
# a different host can run code built for features it lacks. CPU
# compiles are cheap; only the device entry points (bench.py,
# chip_smoke.py, the CLIs via utils/profiling.enable_compile_cache) use
# the cache.


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mmap_pressure():
    """Keep the process under vm.max_map_count (default 65530).

    Every XLA:CPU executable the session-lifetime jit caches retain maps
    its JIT'd code as r-xp/r--p/rw-p anonymous-map triplets; the full
    suite accumulates ~2.5k maps/minute and, at the kernel's default
    ceiling, mmap starts failing mid-compile — observed as a
    deterministic XLA compiler SIGSEGV ~190 tests in (round 4). Clearing
    the jit caches between modules releases the executables (and their
    maps); doing it only above a high-water mark avoids needless
    recompiles for short runs."""
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:  # non-Linux: no ceiling worth guarding
        return
    if n > 30_000:
        jax.clear_caches()
