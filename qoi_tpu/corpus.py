"""Streaming corpus jobs with checkpoint/resume (BASELINE config 5).

Processes a directory of images (the qoi_benchmark_suite layout: PNGs,
possibly nested) through encode / decode / roundtrip, aggregating the
reference harness's grand-total metrics (qoibench.c:559-562). The corpus is
sharded across hosts by file index (SURVEY §5.8: per-host local file I/O;
counters are summed at the end — via `jax.distributed` allreduce when a
multi-host runtime is initialized, else single-host).

Checkpoint/resume (SURVEY §5.4): there is no model state — the resumable
state is the work-queue cursor plus aggregate counters, written as JSON
every `checkpoint_every` images. Restarting with the same arguments picks
up where the job stopped.

    python -m qoi_tpu.corpus <dir> --mode roundtrip \
        --checkpoint /tmp/job.json --shard 0 --num-shards 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Counters:
    images: int = 0
    pixels: int = 0
    raw_bytes: int = 0
    qoi_bytes: int = 0
    encode_ns: float = 0.0
    decode_ns: float = 0.0
    verify_failures: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Counters":
        return cls(**d)

    def summary(self) -> dict:
        enc_s = self.encode_ns / 1e9
        dec_s = self.decode_ns / 1e9
        return {
            "images": self.images,
            "mpixels": self.pixels / 1e6,
            "encode_mpps": (self.pixels / 1e6) / enc_s if enc_s else 0.0,
            "decode_mpps": (self.pixels / 1e6) / dec_s if dec_s else 0.0,
            "rate": self.qoi_bytes / self.raw_bytes if self.raw_bytes else 0.0,
            "verify_failures": self.verify_failures,
        }


@dataclasses.dataclass
class Checkpoint:
    cursor: int
    counters: Counters
    shard: int
    num_shards: int

    def save(self, path) -> None:
        tmp = pathlib.Path(str(path) + ".tmp")
        tmp.write_text(json.dumps({
            "cursor": self.cursor,
            "counters": self.counters.to_json(),
            "shard": self.shard,
            "num_shards": self.num_shards,
        }))
        tmp.replace(path)

    @classmethod
    def load(cls, path) -> Optional["Checkpoint"]:
        p = pathlib.Path(path)
        if not p.exists():
            return None
        d = json.loads(p.read_text())
        return cls(d["cursor"], Counters.from_json(d["counters"]),
                   d["shard"], d["num_shards"])


def shard_files(root: pathlib.Path, shard: int, num_shards: int) -> List[pathlib.Path]:
    files = sorted(root.glob("**/*.png")) + sorted(root.glob("**/*.qoi"))
    return files[shard::num_shards]


def run_job(
    root,
    mode: str = "roundtrip",
    checkpoint_path=None,
    checkpoint_every: int = 50,
    shard: int = 0,
    num_shards: int = 1,
    verify: bool = True,
    oracle_verify: bool = False,
    progress=lambda msg: print(msg, file=sys.stderr),
) -> Counters:
    """Run (or resume) a corpus job over this shard's files.

    `verify` checks the decode roundtrip pixel-exactly; `oracle_verify`
    additionally checks every encoded stream byte-identical to the C++
    oracle (the conformance-suite trust anchor, reference qoi.h:356)."""
    from . import format as fmt, io as qio
    from .models import decode_v3 as decode_pipeline, pipeline
    if oracle_verify:
        from . import oracle

    files = shard_files(pathlib.Path(root), shard, num_shards)
    ck = Checkpoint.load(checkpoint_path) if checkpoint_path else None
    if ck is not None and (ck.shard, ck.num_shards) != (shard, num_shards):
        raise ValueError(
            f"checkpoint is for shard {ck.shard}/{ck.num_shards}, "
            f"job is {shard}/{num_shards}")
    cursor = ck.cursor if ck else 0
    counters = ck.counters if ck else Counters()

    for i in range(cursor, len(files)):
        f = files[i]
        if f.suffix == ".png":
            pixels = qio.load_png(f)
        else:
            pixels, _ = qio.read(f)
        h, w, ch = pixels.shape
        desc = fmt.StreamDesc(w, h, ch)

        t0 = time.perf_counter_ns()
        stream = pipeline.encode(pixels, desc)
        counters.encode_ns += time.perf_counter_ns() - t0
        if oracle_verify and stream != oracle.encode(pixels, desc):
            counters.verify_failures += 1
            progress(f"ORACLE ENCODE MISMATCH: {f}")

        if mode in ("roundtrip", "decode"):
            t0 = time.perf_counter_ns()
            out, _ = decode_pipeline.decode(stream)
            counters.decode_ns += time.perf_counter_ns() - t0
            if verify and not np.array_equal(out, pixels):
                counters.verify_failures += 1
                progress(f"VERIFY FAILED: {f}")

        counters.images += 1
        counters.pixels += w * h
        counters.raw_bytes += pixels.size
        counters.qoi_bytes += len(stream)

        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            Checkpoint(i + 1, counters, shard, num_shards).save(checkpoint_path)
            progress(f"checkpoint @ {i + 1}/{len(files)}")

    if checkpoint_path:
        Checkpoint(len(files), counters, shard, num_shards).save(checkpoint_path)
    return counters


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Bring up the cross-host runtime (SURVEY §5.8: DCN across hosts).

    The three arguments are explicit: nothing tells JAX of a cluster on
    its own, and the same code path runs as N local processes over the
    CPU backend (the 2-process test in tests/test_distributed.py
    exercises exactly this)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)


def allreduce_counters(counters: Counters) -> Counters:
    """Sum counters across hosts when a jax.distributed runtime is up;
    identity on a single host (SURVEY §5.8: one final psum of counters).

    Counters are shipped as (hi, lo) int32 halves of int64 values so the
    sum is exact without `jax_enable_x64` (float32 would corrupt large
    pixel/byte counts; ns timers are integral by construction)."""
    import jax

    if jax.process_count() == 1:
        return counters
    import numpy as np
    from jax.experimental import multihost_utils

    raw = [
        counters.images, counters.pixels, counters.raw_bytes,
        counters.qoi_bytes, int(counters.encode_ns), int(counters.decode_ns),
        counters.verify_failures,
    ]
    halves = np.array(
        [[v >> 31, v & 0x7FFFFFFF] for v in raw], np.int32)  # (7, 2)
    gathered = np.asarray(
        multihost_utils.process_allgather(halves))  # (P, 7, 2)
    totals = [
        int(sum((int(row[0]) << 31) + int(row[1]) for row in gathered[:, k]))
        for k in range(len(raw))
    ]
    vals = totals[:4] + [float(totals[4]), float(totals[5]), totals[6]]
    return Counters(*vals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qoi-tpu-corpus")
    ap.add_argument("root")
    ap.add_argument("--mode", choices=("encode", "decode", "roundtrip"),
                    default="roundtrip")
    ap.add_argument("--checkpoint")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--shard", type=int, default=None)
    ap.add_argument("--num-shards", type=int, default=None)
    ap.add_argument("--noverify", action="store_true")
    ap.add_argument("--oracle-verify", action="store_true",
                    help="also check every stream byte-identical to the "
                         "C++ oracle encoder")
    ap.add_argument("--coordinator", metavar="HOST:PORT",
                    help="bring up jax.distributed across processes; "
                         "shard/num-shards default to the process grid")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    shard, num_shards = args.shard or 0, args.num_shards or 1
    if args.coordinator:
        import jax

        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
        if args.shard is None:
            shard, num_shards = jax.process_index(), jax.process_count()

    counters = run_job(
        args.root, args.mode, args.checkpoint, args.checkpoint_every,
        shard, num_shards, not args.noverify,
        oracle_verify=args.oracle_verify)
    total = allreduce_counters(counters)
    print(json.dumps(total.summary()))
    return 1 if total.verify_failures else 0


if __name__ == "__main__":
    sys.exit(main())
