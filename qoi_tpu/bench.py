"""Benchmark + verification harness (reference L3: qoibench.c).

    python -m qoi_tpu.bench <runs> <dir-of-pngs> [flags]
    python -m qoi_tpu.bench <runs> --synthetic

Mirrors the reference harness semantics: per-image roundtrip verification
before timing (qoibench.c:410-417), a discarded warmup run per codec
(qoibench.c:362-376), recursive *.png directory walking (qoibench.c:491),
and the same metric table — decode/encode ms, Mpixels/s, size KB, rate %
(qoibench.c:340-357). Codecs under test: the device engine (qoi-tpu), the
single-core C++ oracle (qoi-cpp), and PIL PNG (the stb/libpng analog;
skippable with --nopng).

Flags (reference qoibench.c:297-304): --noverify --nowarmup --nopng
--noencode --nodecode --norecurse --onlytotals, plus --json for a
machine-readable summary line.
"""
from __future__ import annotations

import argparse
import io as _stdio
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import format as fmt


@dataclass
class Result:
    """Per-codec accumulated metrics (reference benchmark_result_t,
    qoibench.c:319-332)."""

    decode_ns: float = 0.0
    encode_ns: float = 0.0
    size: int = 0
    px: int = 0
    count: int = 0

    def add(self, other: "Result") -> None:
        self.decode_ns += other.decode_ns
        self.encode_ns += other.encode_ns
        self.size += other.size
        self.px += other.px
        self.count += other.count

    def row(self, raw_bytes: int) -> Dict[str, float]:
        d_ms = self.decode_ns / 1e6 / max(self.count, 1)
        e_ms = self.encode_ns / 1e6 / max(self.count, 1)
        return {
            "decode_ms": d_ms,
            "encode_ms": e_ms,
            "decode_mpps": (self.px / 1e6) / (self.decode_ns / 1e9) if self.decode_ns else 0.0,
            "encode_mpps": (self.px / 1e6) / (self.encode_ns / 1e9) if self.encode_ns else 0.0,
            "size_kb": self.size / 1024 / max(self.count, 1),
            "rate": 100.0 * self.size / raw_bytes if raw_bytes else 0.0,
        }


def _time(fn: Callable, runs: int, warmup: bool) -> float:
    """Best-of-runs wall time in ns, with an optional discarded warmup
    (reference BENCHMARK_FN, qoibench.c:364-376)."""
    if warmup:
        fn()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter_ns()
        fn()
        best = min(best, time.perf_counter_ns() - t0)
    return best


def _png_codec():
    from PIL import Image

    def enc(pixels: np.ndarray) -> bytes:
        buf = _stdio.BytesIO()
        mode = "RGB" if pixels.shape[-1] == 3 else "RGBA"
        Image.fromarray(pixels, mode).save(buf, format="PNG")
        return buf.getvalue()

    def dec(data: bytes) -> np.ndarray:
        return np.asarray(Image.open(_stdio.BytesIO(data)))

    return enc, dec


def bench_image(name: str, pixels: np.ndarray, opts,
                totals: Dict[str, Result]) -> None:
    h, w, ch = pixels.shape
    desc = fmt.StreamDesc(w, h, ch)
    n_px = w * h
    raw = n_px * ch

    from . import oracle
    from .models import decode_v3 as decode_pipeline, pipeline

    stream = oracle.encode(pixels, desc)

    # -- verification gate (reference qoibench.c:410-417)
    if not opts.noverify:
        enc_tpu = pipeline.encode(pixels, desc)
        if enc_tpu != stream:
            sys.exit(f"VERIFY: tpu encode of {name} mismatches oracle")
        dec_tpu, _ = decode_pipeline.decode(stream)
        if not np.array_equal(dec_tpu.reshape(h, w, ch), pixels):
            sys.exit(f"VERIFY: tpu decode of {name} mismatches source")

    codecs: Dict[str, Dict[str, Callable]] = {
        "qoi-tpu": dict(
            encode=lambda: pipeline.encode(pixels, desc),
            decode=lambda: decode_pipeline.decode(stream),
            size=len(stream),
        ),
        "qoi-cpp": dict(
            encode=lambda: oracle.encode(pixels, desc),
            decode=lambda: oracle.decode(stream),
            size=len(stream),
        ),
    }
    if not opts.nopng:
        penc, pdec = _png_codec()
        png_bytes = penc(pixels)
        codecs["png-pil"] = dict(
            encode=lambda: penc(pixels),
            decode=lambda: pdec(png_bytes),
            size=len(png_bytes),
        )

    rows: Dict[str, Result] = {}
    for cname, c in codecs.items():
        r = Result(size=c["size"], px=n_px, count=1)
        if not opts.nodecode:
            r.decode_ns = _time(c["decode"], opts.runs, not opts.nowarmup)
        if not opts.noencode:
            r.encode_ns = _time(c["encode"], opts.runs, not opts.nowarmup)
        rows[cname] = r
        totals.setdefault(cname, Result()).add(r)

    if not opts.onlytotals:
        print(f"## {name} — {w}x{h} {ch}ch")
        _print_table(rows, raw)


def _print_table(rows: Dict[str, Result], raw_bytes: int) -> None:
    """The reference's metric table (qoibench.c:340-357)."""
    hdr = f"{'':12s}{'decode ms':>12s}{'encode ms':>12s}{'decode mpps':>13s}{'encode mpps':>13s}{'size kb':>10s}{'rate':>7s}"
    print(hdr)
    for name, r in rows.items():
        m = r.row(raw_bytes)
        print(f"{name:12s}{m['decode_ms']:12.3f}{m['encode_ms']:12.3f}"
              f"{m['decode_mpps']:13.2f}{m['encode_mpps']:13.2f}"
              f"{m['size_kb']:10.0f}{m['rate']:6.1f}%")
    print()


def _walk_pngs(root: pathlib.Path, recurse: bool) -> List[pathlib.Path]:
    pat = "**/*.png" if recurse else "*.png"
    return sorted(root.glob(pat))


def synthetic_suite(kind: str = "full"):
    from .utils import testimages

    if kind == "small":
        return [
            ("64x64_rgb", testimages.mixed(64, 64, 3)),
            ("48x32_rgba", testimages.mixed(48, 32, 4)),
        ]
    return testimages.bench_suite()


def scaling_sweep(opts) -> int:
    """Tiled (sequence-parallel) encode+decode over growing meshes; prints
    per-shard-count Mpx/s and scaling efficiency (SURVEY §5.5: N-device
    Mpx/s / (N x 1-device Mpx/s))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from . import format as fmt
    from .parallel import sharding, tiled, tiled_decode
    from .utils import profiling, testimages

    devs = jax.devices()
    img = testimages.photo(1024, 512, 4)
    desc = fmt.StreamDesc(1024, 512, 4)
    stream = None
    enc_mpps, dec_mpps = {}, {}
    n_px = desc.num_pixels
    s = 1
    while s <= len(devs):
        mesh = Mesh(np.asarray(devs[:s]).reshape(s), (sharding.SEQ_AXIS,))
        dt = profiling.device_sync_time(
            lambda m=mesh: jnp.asarray(
                len(tiled.encode_tiled(img, desc, m))), reps=opts.runs)
        enc_mpps[s] = n_px / 1e6 / dt
        if stream is None:
            stream = tiled.encode_tiled(img, desc, mesh)
        ddt = profiling.device_sync_time(
            lambda m=mesh: jnp.asarray(
                tiled_decode.decode_tiled(stream, m)[0].sum()),
            reps=opts.runs)
        dec_mpps[s] = n_px / 1e6 / ddt
        s *= 2

    enc_eff = profiling.scaling_efficiency(enc_mpps)
    dec_eff = profiling.scaling_efficiency(dec_mpps)
    print("# scaling sweep (tiled single-stream, 1024x512 RGBA)")
    print("shards   encode mpps   eff     decode mpps   eff")
    for k in sorted(enc_mpps):
        print(f"{k:6d}   {enc_mpps[k]:11.2f}   {enc_eff[k]:5.2f}   "
              f"{dec_mpps[k]:11.2f}   {dec_eff[k]:5.2f}")
    if opts.json:
        print(json.dumps({
            "encode_mpps": enc_mpps, "encode_eff": enc_eff,
            "decode_mpps": dec_mpps, "decode_eff": dec_eff,
        }, default=float))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="qoi-tpu-bench", description="QOI benchmark harness (device engine)")
    ap.add_argument("runs", type=int, help="timed runs per codec per image")
    ap.add_argument("target", nargs="?", help="directory of .png files")
    ap.add_argument("--synthetic", nargs="?", const="full",
                    choices=("small", "full"),
                    help="use the built-in synthetic suite instead of a dir")
    for flag in ("noverify", "nowarmup", "nopng", "noencode", "nodecode",
                 "norecurse", "onlytotals"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON grand-total line")
    ap.add_argument("--scaling", action="store_true",
                    help="sequence-parallel scaling sweep: encode one "
                         "image tiled over 1..N devices and report Mpx/s "
                         "plus scaling efficiency per shard count "
                         "(timings need real devices — on the forced-CPU "
                         "test mesh this exercises the code path only)")
    opts = ap.parse_args(argv)
    if opts.runs < 1:
        ap.error("runs must be >= 1")
    from .utils import profiling
    profiling.enable_compile_cache()
    if opts.scaling:
        return scaling_sweep(opts)

    images = []
    if opts.synthetic:
        images = synthetic_suite(opts.synthetic)
    elif opts.target:
        from . import io as qio

        paths = _walk_pngs(pathlib.Path(opts.target), not opts.norecurse)
        if not paths:
            ap.error(f"no .png files under {opts.target}")
        images = [(str(p), qio.load_png(p)) for p in paths]
    else:
        ap.error("need a directory or --synthetic")

    totals: Dict[str, Result] = {}
    raw_total = 0
    for name, pixels in images:
        raw_total += pixels.size
        bench_image(name, pixels, opts, totals)

    print(f"# Grand total for {len(images)} images")
    _print_table(totals, raw_total)

    if opts.json:
        summary = {name: r.row(raw_total) for name, r in totals.items()}
        summary["images"] = len(images)
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
