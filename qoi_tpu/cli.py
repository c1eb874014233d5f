"""Converter CLI (reference L3: qoiconv.c).

    python -m qoi_tpu.cli <infile> <outfile> [--engine tpu|scan|oracle]
                                             [--verify]

Dispatches on filename suffix like the reference (qoiconv.c:45-64):
.png -> .qoi encodes, .qoi -> .png decodes, .qoi -> .qoi re-encodes.
`--verify` differentially checks the result against the C++ oracle codec.
The QOI colorspace header byte is written as sRGB, matching the
reference's hardcoded choice (qoiconv.c:79).
"""
from __future__ import annotations

import argparse
import sys

from . import config as cfg
from . import format as fmt, io


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="qoi-tpu-conv", description="QOI <-> PNG converter (device engine)")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--engine", choices=("tpu", "scan", "oracle"),
                    default="tpu", help="codec engine (default: tpu)")
    ap.add_argument("--verify", action="store_true",
                    help="differentially check output against the C++ oracle")
    ap.add_argument("--max-rounds", type=int,
                    default=cfg.DEFAULT.decode_max_iters, metavar="N",
                    help="decode fixpoint cap before sequential fallback")
    ap.add_argument("--bucket-floor", type=int,
                    default=cfg.DEFAULT.bucket_floor, metavar="N",
                    help="shape-bucketing floor (compiled-shape granularity)")
    args = ap.parse_args(argv)
    from .utils import profiling
    profiling.enable_compile_cache()
    config = cfg.EngineConfig(
        engine=args.engine, verify=args.verify,
        decode_max_iters=args.max_rounds, bucket_floor=args.bucket_floor)
    config.validate()

    src, dst = args.infile.lower(), args.outfile.lower()
    if not (src.endswith(".png") or src.endswith(".qoi")):
        ap.error(f"unsupported input {args.infile} (want .png or .qoi)")
    if not (dst.endswith(".png") or dst.endswith(".qoi")):
        ap.error(f"unsupported output {args.outfile} (want .png or .qoi)")

    # -- load pixels
    if src.endswith(".png"):
        pixels = io.load_png(args.infile)
        desc = io.image_desc(pixels)
    else:
        try:
            pixels, desc = io.read(args.infile, engine=config)
        except AssertionError as e:  # config.verify mismatch
            print(f"VERIFY FAILED: {e}", file=sys.stderr)
            return 1
        desc = fmt.StreamDesc(desc.width, desc.height, desc.channels)

    # -- write
    if dst.endswith(".qoi"):
        try:
            n = io.write(args.outfile, pixels, desc, engine=config)
        except AssertionError as e:  # config.verify mismatch
            print(f"VERIFY FAILED: {e}", file=sys.stderr)
            return 1
        print(f"{args.outfile}: {n} bytes "
              f"({100 * n / (desc.num_pixels * desc.channels):.1f}% of raw)")
    else:
        io.save_png(args.outfile, pixels)
        print(f"{args.outfile}: {desc.width}x{desc.height} "
              f"{desc.channels}ch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
