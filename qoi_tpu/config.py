"""Engine configuration (SURVEY §5.6).

The reference's configuration is compile-time macros (QOI_IMPLEMENTATION,
QOI_NO_STDIO, QOI_MALLOC/FREE — qoi.h:18-58) plus qoibench argv flags.
Here one dataclass covers the engine tunables; CLI tools map their argv
onto it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tunables for the device codec engine."""

    # which codec drives encode/decode: "tpu" (the parallel device
    # pipeline; the name predates the GPU port),
    # "scan" (sequential lax.scan anchor), "oracle" (C++ host codec)
    engine: str = "tpu"

    # verify every encode/decode differentially against the oracle
    verify: bool = False

    # shape-bucketing floor (compiled-program count is O(log max-size))
    bucket_floor: int = 256

    # ops/table.py within-block brute-force width (<= 127); threaded
    # through models/pipeline.encode -> encode_stage_chunks -> table_hit
    table_block: int = 64

    # models/streamed.py tile size (pixels for encode, bytes for decode);
    # the facade qoi_tpu.encode/decode pass it to the streamed drivers
    stream_tile_px: int = 1 << 22

    # decode fixpoint iteration cap before sequential fallback
    # (models/decode_v3.decode, models/streamed.decode)
    decode_max_iters: int = 12

    # (data, seq) mesh shape; None = single device. When set, io.read /
    # io.write run the sequence-parallel tiled codec over that mesh
    mesh: Optional[Tuple[int, int]] = None

    def validate(self) -> None:
        if self.engine not in ("tpu", "scan", "oracle"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if not 1 <= self.table_block <= 127:
            raise ValueError("table_block must be in [1, 127]")
        if self.bucket_floor < 1 or self.stream_tile_px < 2:
            raise ValueError("bad bucket_floor / stream_tile_px")
        if self.mesh is not None and (self.mesh[0] < 1 or self.mesh[1] < 1):
            raise ValueError(f"bad mesh {self.mesh}")


DEFAULT = EngineConfig()
