#!/usr/bin/env python3
"""Smoke run of the codec's main paths on a GPU, checked against the oracle.

    python chip_smoke.py            # one GPU: every single-card phase
    python chip_smoke.py --chips 4  # four GPUs: the sharded phase only

Single card, in one process (a second process could not open the card):

  setup      build the C++ oracle library, print the card and devices
  single     qoi_tpu.encode/decode of a 4K RGBA `mixed` and a 4K RGB
             `photo` frame, bytes and pixels against the oracle
  batch      batch.encode_batch of 8 mixed 4K frames; batch.decode_batch
             of 32 4K streams (16 photo, 16 mixed: 4 frames of each class,
             each 4 times, chosen so all 32 fall in one shape group and
             take decode_group's chunked sub_batch=16 program), with
             every lane converged on the device
  streamed   qoi_tpu.encode/decode of one 8K RGBA frame (33.2 Mpx, above
             STREAM_THRESHOLD_PX, so models/streamed.py)
  hostile    qoi_tpu.decode of a 4K stream of INDEX reads of never-written
             slots (the fallback ladder)

Four cards (`--chips 4`): parallel/tiled.encode_tiled of a 5120x3280 RGBA
frame over a (data=1, seq=4) mesh against the oracle and the one-card
encode; the sharded decode with on-device expansion
(tiled_decode._decode_expand_device, convergence asserted on every shard);
__graft_entry__.dryrun_multichip(4).

Every comparison is exact. A mismatch or a failed phase raises, so the
script exits non-zero and prints no result line; on success the last
line of stdout is one JSON object naming the device. The times printed
on earlier lines are smoke timings of single calls, not benchmark
numbers. Without a GPU the script exits non-zero before any phase runs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
TIMING = "[smoke timing, not a benchmark]"


class SmokeFailure(AssertionError):
    """A phase produced output that differs from the reference."""


def log(msg: str) -> None:
    print(msg, flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed(label: str, fn, reps: int = 3):
    """Run `fn` once (compile + first run), then best-of-`reps`, each call
    ending in jax.block_until_ready on every output; returns the first
    call's result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    log(f"{TIMING} {label}: first call {first:.3f} s, "
        f"best of {reps} {best * 1e3:.3f} ms")
    return out


def memory(label: str, jitted, *args, **static) -> None:
    """Print compiled.memory_analysis() of `jitted` at these arguments."""
    ma = jitted.lower(*args, **static).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    parts = [f"{f[:-len('_size_in_bytes')]}="
             f"{getattr(ma, f, 0) / 2**20:.1f} MiB" for f in fields]
    log(f"{TIMING} memory_analysis {label}: " + ", ".join(parts))


def _device_peak() -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"{TIMING} device peak_bytes_in_use so far: "
            f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB")


def _pack_streams(streams):
    """(data (B, cap) u8, chunk lengths (B,) i32, n_px_cap) for streams
    of one shape group, packed as batch.decode_batch packs them."""
    from qoi_tpu import format as fmt
    from qoi_tpu.models import decode_pipeline as v1

    caps = {v1.bucket_size_fine(len(s) - fmt.HEADER_SIZE) for s in streams}
    npcs = {v1.bucket_size(fmt.unpack_header(s).num_pixels) for s in streams}
    _check(len(caps) == 1 and len(npcs) == 1,
           f"streams span several shape groups: caps {caps}, px {npcs}")
    cap, npc = caps.pop(), npcs.pop()
    data = np.zeros((len(streams), cap), np.uint8)
    clens = np.zeros((len(streams),), np.int32)
    for i, s in enumerate(streams):
        body = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
        data[i, : len(body)] = body
        clens[i] = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    return data, clens, npc


def phase_single(w: int = 3840, h: int = 2160) -> None:
    """qoi_tpu.encode/decode of one RGBA mixed and one RGB photo frame."""
    import jax.numpy as jnp

    import qoi_tpu
    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import decode_v3, pipeline
    from qoi_tpu.utils import testimages

    for name, img in (("mixed RGBA", testimages.mixed(w, h, 4, seed=3)),
                      ("photo RGB", testimages.photo(w, h, 3, seed=3))):
        desc = fmt.StreamDesc(w, h, img.shape[2])
        _check(desc.num_pixels <= qoi_tpu.STREAM_THRESHOLD_PX,
               "single-image phase must stay below the streaming threshold")
        want = oracle.encode(img, desc)
        got = timed(f"single {name} qoi_tpu.encode",
                    lambda: qoi_tpu.encode(img, desc))
        _check(got == want, f"single {name}: encode differs from the oracle")
        want_px, want_desc = oracle.decode(want)
        px, got_desc = timed(f"single {name} qoi_tpu.decode",
                             lambda: qoi_tpu.decode(want))
        _check(got_desc == want_desc and np.array_equal(px, want_px),
               f"single {name}: decode differs from the oracle")
        log(f"single {name} {w}x{h}: encode and decode oracle-exact "
            f"({len(want)} bytes)")

    # the device programs behind those calls, timed and sized on their own
    desc = fmt.StreamDesc(w, h, 4)
    px4 = pipeline.force_rgba(testimages.mixed(w, h, 4, seed=3), desc)
    padded = np.zeros((pipeline.bucket_size(desc.num_pixels), 4), np.uint8)
    padded[: desc.num_pixels] = px4
    x, nv = jnp.asarray(padded), jnp.int32(desc.num_pixels)
    timed("single encode_device_wordsum (device program)",
          lambda: pipeline.encode_device_wordsum(x, nv))
    memory("encode_device_wordsum", pipeline.encode_device_wordsum, x, nv)
    data, clens, npc = _pack_streams([oracle.encode(
        testimages.mixed(w, h, 4, seed=3), desc)])
    d, c = jnp.asarray(data[0]), jnp.int32(clens[0])
    out, conv, _ = timed("single decode_v3._decode_device (device program)",
                         lambda: decode_v3._decode_device(d, c, npc))
    _check(bool(conv), "single mixed RGBA: device decode did not converge")
    memory("decode_v3._decode_device", decode_v3._decode_device, d, c,
           n_px_cap=npc)
    _device_peak()


def phase_batch(w: int = 3840, h: int = 2160, n_encode: int = 8,
                n_decode_each: int = 16, sub_batch: int = 16,
                n_unique: int = 4) -> None:
    """batch.encode_batch and batch.decode_batch against the oracle, with
    every decode lane converged on the device. The decode batch repeats
    `n_unique` frames of each class; seeds 3.. put every 4K stream of
    both classes in one stream-size bucket."""
    import jax.numpy as jnp

    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import batch, decode_v3
    from qoi_tpu.utils import testimages

    desc = fmt.StreamDesc(w, h, 4)
    frames = [testimages.mixed(w, h, 4, seed=10 + i) for i in range(n_encode)]
    got = timed(f"batch encode_batch {n_encode}x{w}x{h}",
                lambda: batch.encode_batch(frames))
    for i, (f, s) in enumerate(zip(frames, got)):
        _check(s == oracle.encode(f, desc),
               f"batch encode frame {i} differs from the oracle")
    log(f"batch encode: {n_encode} frames oracle-exact")

    uniq = ([oracle.encode(testimages.photo(w, h, 4, seed=3 + i), desc)
             for i in range(n_unique)]
            + [oracle.encode(testimages.mixed(w, h, 4, seed=3 + i), desc)
               for i in range(n_unique)])
    reps = n_decode_each // n_unique
    streams = ([s for s in uniq[:n_unique] for _ in range(reps)]
               + [s for s in uniq[n_unique:] for _ in range(reps)])
    wants = {s: oracle.decode(s) for s in uniq}
    results = timed(f"batch decode_batch {len(streams)}x{w}x{h}",
                    lambda: batch.decode_batch(streams))
    for i, ((px, d, err), s) in enumerate(zip(results, streams)):
        want, want_desc = wants[s]
        _check(err is None and d == want_desc and np.array_equal(px, want),
               f"batch decode stream {i} differs from the oracle")
    log(f"batch decode: {len(streams)} streams oracle-exact")

    # the same group through decode_group, as decode_batch calls it: every
    # lane must converge on the device, or the host ladder would have
    # stood in for the GPU decode above
    data, clens, npc = _pack_streams(streams)
    dd, cc = jnp.asarray(data), jnp.asarray(clens)
    _, conv = timed(f"batch decode_group {len(streams)} lanes "
                    f"(device program)",
                    lambda: decode_v3.decode_group(dd, cc, npc,
                                                   sub_batch=sub_batch))
    conv = np.asarray(conv)
    _check(bool(conv.all()),
           f"batch decode: lanes {np.flatnonzero(~conv).tolist()} did not "
           f"converge on the device")
    log(f"batch decode: all {len(streams)} lanes converged on the device")
    b = len(streams)
    if b > sub_batch and b % sub_batch == 0:
        memory("decode_v3._decode_device_batch_chunked",
               decode_v3._decode_device_batch_chunked, dd, cc,
               n_px_cap=npc, sub_batch=sub_batch)
    else:
        memory("decode_v3._decode_device_batch",
               decode_v3._decode_device_batch, dd, cc, n_px_cap=npc)
    _device_peak()


def phase_streamed(w: int = 7680, h: int = 4320, config=None) -> None:
    """qoi_tpu.encode/decode of a frame above STREAM_THRESHOLD_PX, with
    the default engine configuration unless `config` is given."""
    import jax
    import jax.numpy as jnp

    import qoi_tpu
    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import decode_pipeline as v1
    from qoi_tpu.models import pipeline, streamed
    from qoi_tpu.utils import testimages

    desc = fmt.StreamDesc(w, h, 4)
    _check(desc.num_pixels > qoi_tpu.STREAM_THRESHOLD_PX,
           "streamed phase must exceed the streaming threshold")
    img = testimages.mixed(w, h, 4, seed=7)
    want = oracle.encode(img, desc)
    kw = {} if config is None else {"engine": config}
    got = timed(f"streamed qoi_tpu.encode {w}x{h}",
                lambda: qoi_tpu.encode(img, desc, **kw))
    _check(got == want, "streamed encode differs from the oracle")
    want_px, want_desc = oracle.decode(want)
    px, got_desc = timed(f"streamed qoi_tpu.decode {w}x{h}",
                         lambda: qoi_tpu.decode(want, **kw))
    _check(got_desc == want_desc and np.array_equal(px, want_px),
           "streamed decode differs from the oracle")
    log(f"streamed {w}x{h} ({desc.num_pixels / 1e6:.1f} Mpx): encode and "
        f"decode oracle-exact")

    t = config.stream_tile_px if config else 1 << 22
    t = min(t, pipeline.bucket_size(desc.num_pixels))
    cap = 5 * (-(-desc.num_pixels // t)) * t + 6 * t
    memory("streamed._enc_tile", streamed._enc_tile,
           jax.ShapeDtypeStruct((cap,), jnp.uint8),
           jax.ShapeDtypeStruct((t, 4), jnp.uint8), jnp.int32(0),
           jnp.int32(0), jnp.int32(desc.num_pixels),
           pipeline.EncoderCarry.seed())
    # the decode tile program, at the shapes streamed.decode gives it
    tb = max(1024, t)
    p_budget = max(tb, streamed._PX_BUDGET_MIN)
    chunks_len = len(want) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    memory("streamed._dec_tile_at", streamed._dec_tile_at,
           jax.ShapeDtypeStruct(
               (v1.bucket_size(desc.num_pixels) + p_budget,), jnp.uint32),
           jax.ShapeDtypeStruct((chunks_len + tb,), jnp.uint8),
           jnp.int32(0), jnp.int32(0), jnp.int32(chunks_len),
           jnp.zeros((65,), jnp.uint32), t=tb, p_budget=p_budget,
           max_rounds=config.decode_max_iters if config else 12)
    _device_peak()


def phase_hostile(w: int = 3840, h: int = 2160) -> None:
    """A stream of INDEX reads of never-written slots through the ladder."""
    import jax.numpy as jnp

    import qoi_tpu
    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import decode_v3

    desc = fmt.StreamDesc(w, h, 4)
    stream = (fmt.pack_header(desc)
              + bytes([fmt.OP_INDEX | 5]) * desc.num_pixels + fmt.TRAILER)
    want_px, want_desc = oracle.decode(stream)
    px, got_desc = timed(f"hostile qoi_tpu.decode {w}x{h}",
                         lambda: qoi_tpu.decode(stream))
    _check(got_desc == want_desc and np.array_equal(px, want_px),
           "hostile decode differs from the oracle")
    log(f"hostile {w}x{h}: ladder decode oracle-exact")
    data, clens, npc = _pack_streams([stream])
    memory("decode_v3._decode_device (hostile stream)",
           decode_v3._decode_device, jnp.asarray(data[0]),
           jnp.int32(clens[0]), n_px_cap=npc)
    _device_peak()


def phase_four_cards(w: int = 5120, h: int = 3280, n_devices: int = 4) -> None:
    """Sequence-parallel encode and decode over a (1, 4) mesh, plus the
    graft entry's 2x2 dry run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import qoi_tpu
    import __graft_entry__
    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.parallel import sharding, tiled, tiled_decode
    from qoi_tpu.utils import testimages

    _check(len(jax.devices()) >= n_devices,
           f"need {n_devices} devices, have {len(jax.devices())}")
    mesh = sharding.make_mesh(data=1, seq=n_devices)
    desc = fmt.StreamDesc(w, h, 4)
    img = testimages.mixed(w, h, 4, seed=17)
    want = oracle.encode(img, desc)
    got = timed(f"tiled encode_tiled {w}x{h} over seq={n_devices}",
                lambda: tiled.encode_tiled(img, desc, mesh))
    _check(got == want, "tiled encode differs from the oracle")
    one = timed(f"one-device qoi_tpu.encode {w}x{h}",
                lambda: qoi_tpu.encode(img, desc))
    _check(one == got, "tiled encode differs from the one-device encode")
    log(f"tiled encode {w}x{h} over {n_devices} devices: oracle-exact and "
        f"identical to the one-device encode")

    # the sharded decode, called directly: decode_tiled would fall back to
    # one device on non-convergence and hide a broken sharded resolve
    body = np.frombuffer(want, np.uint8)[fmt.HEADER_SIZE:]
    chunks_len = len(want) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
    s = mesh.shape[sharding.SEQ_AXIS]
    mb = max(-(-len(body) // s), 8)
    padded = np.zeros((s * mb,), np.uint8)
    padded[: len(body)] = body
    n_px = desc.num_pixels
    n_px_cap = -(-n_px // (64 * s)) * 64 * s
    xd = jax.device_put(padded, NamedSharding(mesh, P(sharding.SEQ_AXIS)))
    px32, conv = timed(
        f"tiled _decode_expand_device {w}x{h} over seq={n_devices}",
        lambda: tiled_decode._decode_expand_device(
            xd, jnp.int32(chunks_len), mesh=mesh, axis=sharding.SEQ_AXIS,
            n_px_cap=n_px_cap))
    conv = np.asarray(conv)
    _check(bool(conv.all()),
           f"sharded decode: shards {np.flatnonzero(~conv).tolist()} did "
           f"not converge")
    dec = np.ascontiguousarray(np.asarray(px32)).view(np.uint8).reshape(
        -1, 4)[:n_px]
    want_px, _ = oracle.decode(want)
    _check(np.array_equal(dec.reshape(h, w, 4), want_px),
           "sharded decode differs from the oracle")
    log(f"tiled decode {w}x{h} over {n_devices} devices: every shard "
        f"converged, oracle-exact")

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices)
    log(f"{TIMING} dryrun_multichip({n_devices}): "
        f"{time.perf_counter() - t0:.3f} s")


def setup() -> None:
    """Build the oracle library (only it: the CLIs need libpng) and load it."""
    from qoi_tpu import oracle

    subprocess.run(["make", "-s", "-C", str(ROOT / "cpp"),
                    "build/libqoi_oracle.so"], check=True)
    _check(oracle.available(), "the C++ oracle library did not load")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    from qoi_tpu.utils import profiling

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 1
    log(f"compile cache: {profiling.enable_compile_cache()}")
    for name, power_limit in profiling.gpu_cards():
        log(f"{name}, {power_limit}")
    log(f"jax.devices(): {devices}")
    setup()

    phases = ([phase_four_cards] if args.chips == 4 else
              [phase_single, phase_batch, phase_streamed, phase_hostile])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"{TIMING} phase {phase.__name__}: "
            f"{time.perf_counter() - t0:.1f} s wall")

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
