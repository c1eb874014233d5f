#!/usr/bin/env python3
"""Headline benchmark: single-device QOI encode + decode throughput,
batched 4K RGBA, on a GPU.

Mirrors the reference benchmark's metric (Mpixels/s, qoibench.c:340-357)
on BASELINE.json configs 2/3: 4K RGBA frames, many frames in flight per
timed rep. Every timed program is first verified against the C++ oracle
(bytes for encode, pixels for decode); a mismatch, a missing oracle or a
non-GPU device aborts the run before any number is printed.

Prints ONE JSON line on stdout:
  {"metric": "encode_4k_rgba_batch_throughput", "value": N, "unit": "Mpx/s",
   "decode_mpxs": N, "decode_mixed_mpxs": N, "decode_adversarial_mpxs": N,
   "device": {"platform", "kind", "count", "card", "power_limit"}}
Diagnostics (SOL fractions, compile times) go to stderr.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

W, H = 3840, 2160
BATCH = 8
ENC_DISPATCH = 4  # 32 encode programs per rep over the 8 unique frames
DEC_REPEAT = 4    # 32 decode lanes per rep over the 8 unique streams
REPS = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from qoi_tpu import format as fmt, oracle
    from qoi_tpu.models import decode_pipeline as v1
    from qoi_tpu.models import decode_v3, pipeline
    from qoi_tpu.utils import profiling, testimages

    profiling.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform!r}")
    card, power_limit = profiling.gpu_cards()[0]
    bw = profiling.peak_bytes_per_s(dev.device_kind)
    log(f"device: {dev.device_kind} ({dev.platform}), card {card}, "
        f"power limit {power_limit}")
    if not oracle.available():
        raise SystemExit("the C++ oracle could not be built: nothing to "
                         "verify against (make -C cpp build/libqoi_oracle.so)")

    desc = fmt.StreamDesc(W, H, 4)
    n = desc.num_pixels
    cap = -(-n // 1024) * 1024

    frames = [testimages.mixed(W, H, 4, seed=3 + i) for i in range(BATCH)]
    batch = np.zeros((BATCH, cap, 4), np.uint8)
    for i, f in enumerate(frames):
        batch[i, :n] = pipeline.force_rgba(f, desc)
    xs = [jax.device_put(batch[i]) for i in range(BATCH)]

    # ONE fused program per frame (word-form staging + word-sum
    # compaction), all frames of a rep dispatched before the rep waits
    def encode_frames():
        return [pipeline.encode_device_wordsum(x, jnp.int32(n))
                for x in xs * ENC_DISPATCH]

    t0 = time.perf_counter()
    outs = jax.block_until_ready(encode_frames())
    log(f"encode compile+first run: {time.perf_counter() - t0:.1f}s")
    # every unique frame must be byte-identical to the oracle
    for i, (words, total) in enumerate(outs[:BATCH]):
        raw = np.asarray(words).view(np.uint8)[: int(total)]
        stream = fmt.pack_header(desc) + raw.tobytes() + fmt.TRAILER
        if oracle.encode(frames[i], desc) != stream:
            raise SystemExit(f"VERIFY FAILED: encode frame {i} differs "
                             f"from the oracle")
    log(f"verified: all {BATCH} frames byte-identical to oracle encode")
    kib = int(outs[0][1]) / 1024
    del outs  # ~1.6 GB of output buffers, not needed while decode runs

    dt = profiling.device_sync_time(encode_frames, reps=REPS)
    enc_frames_n = BATCH * ENC_DISPATCH
    enc_mpxs = (enc_frames_n * n / 1e6) / dt
    enc_sol = profiling.encode_sol_model(enc_frames_n * n, 4, bw)
    log(f"encode {enc_frames_n}x4K RGBA: {dt * 1e3:.2f} ms/batch, "
        f"{enc_mpxs:.1f} Mpx/s, {kib:.0f} KiB/stream, "
        f"SOL fraction {enc_mpxs / enc_sol['sol_mpps']:.3f}")

    # ---- decode: one chunked program over 32 lanes ----------------------
    # TWO content classes: constant-alpha `photo` (the written-slot
    # estimate is exact, one fixpoint round) and alpha-toggling `mixed`
    # (the anchored rebuild converges it in two rounds). The reference
    # decode loop (qoi.h:488) is content-insensitive, so both count.
    dframes = [testimages.photo(W, H, 4, seed=3 + i) for i in range(BATCH)]
    dsources = []
    for f in dframes:
        buf = np.zeros((cap, 4), np.uint8)
        buf[:n] = pipeline.force_rgba(f, desc)
        dsources.append(jax.device_put(buf))
    streams = [oracle.encode(f, desc) for f in dframes]
    streams_mixed = [oracle.encode(f, desc) for f in frames]

    # one shape bucket for both classes => ONE compiled decode program
    mcap = v1.bucket_size_fine(
        max(len(s) for s in streams + streams_mixed) - fmt.HEADER_SIZE)
    npc = v1.bucket_size(n)

    def to_device_batch(strms):
        bodies = np.zeros((BATCH, mcap), np.uint8)
        clens = np.zeros((BATCH,), np.int32)
        for i, s in enumerate(strms):
            raw = np.frombuffer(s, np.uint8)[fmt.HEADER_SIZE:]
            bodies[i, : len(raw)] = raw
            clens[i] = len(s) - fmt.HEADER_SIZE - fmt.TRAILER_SIZE
        # the 32 lanes repeat the 8 uploaded streams, tiled on device
        db = jnp.tile(jax.device_put(bodies), (DEC_REPEAT, 1))
        dc = jnp.tile(jax.device_put(clens), DEC_REPEAT)
        return db, dc

    dec_batch = DEC_REPEAT * BATCH

    @jax.jit
    def decode_batch(d, c):
        return decode_v3.decode_group(d, c, npc)

    # device-side exactness gate: decoded packed px vs the uploaded
    # source pixels (the sources ARE the oracle's input)
    @jax.jit
    def check_one(out, px4):
        want = (px4[:, 0].astype(jnp.uint32)
                | px4[:, 1].astype(jnp.uint32) << 8
                | px4[:, 2].astype(jnp.uint32) << 16
                | px4[:, 3].astype(jnp.uint32) << 24)
        return jnp.all(out[:n] == want[:n])

    def bench_decode(label, db, dc, srcs):
        t0 = time.perf_counter()
        out, conv = jax.block_until_ready(decode_batch(db, dc))
        log(f"decode[{label}] compile+first run: "
            f"{time.perf_counter() - t0:.1f}s")
        if not bool(jnp.all(conv)):
            raise SystemExit(f"decode[{label}]: a canonical stream did not "
                             f"converge on the device")
        for i in range(dec_batch):
            if not bool(check_one(out[i], srcs[i % BATCH])):
                raise SystemExit(f"VERIFY FAILED: {label} lane {i} decode "
                                 f"differs from its source pixels")
        log(f"verified: all {dec_batch} {label} decodes pixel-identical")
        del out, conv
        ddt = profiling.device_sync_time(lambda: decode_batch(db, dc),
                                         reps=REPS)
        mpxs = (dec_batch * n / 1e6) / ddt
        sol = profiling.decode_sol_model(dec_batch * n, 4, bw)
        log(f"decode[{label}] {dec_batch}x4K RGBA: {ddt * 1e3:.2f} ms/batch, "
            f"{mpxs:.1f} Mpx/s, SOL fraction {mpxs / sol['sol_mpps']:.3f}")
        return mpxs

    dec_mpxs = bench_decode("photo", *to_device_batch(streams), dsources)
    mix_mpxs = bench_decode("mixed", *to_device_batch(streams_mixed), xs)

    # ---- adversarial (non-canonical) decode: the ladder path ------------
    # OP_INDEX reads of never-written table slots violate the decoder
    # fixpoint's table invariant by construction, so the device fixpoint
    # stalls and the fallback ladder pays: device rounds + stall bail +
    # the native C++ host decode.
    adv_stream = (fmt.pack_header(desc)
                  + b"\x05" * n          # INDEX slot 5, never written
                  + fmt.TRAILER)
    want_img, _ = oracle.decode(adv_stream)
    t0 = time.perf_counter()
    img, _ = decode_v3.decode(adv_stream)
    warm = time.perf_counter() - t0
    if not np.array_equal(img, want_img):
        raise SystemExit("VERIFY FAILED: adversarial decode differs from "
                         "the oracle")
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_v3.decode(adv_stream)
        ts.append(time.perf_counter() - t0)
    adv_mpxs = n / 1e6 / min(ts)
    log(f"decode[adversarial] 1x4K INDEX-unwritten: first {warm:.1f}s, "
        f"min {min(ts) * 1e3:.0f} ms, {adv_mpxs:.1f} Mpx/s "
        f"(ladder: device stall-bail + native host decode)")

    print(json.dumps({
        "metric": "encode_4k_rgba_batch_throughput",
        "value": enc_mpxs,
        "unit": "Mpx/s",
        "decode_mpxs": dec_mpxs,
        "decode_mixed_mpxs": mix_mpxs,
        "decode_adversarial_mpxs": adv_mpxs,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card,
                   "power_limit": power_limit},
    }))


if __name__ == "__main__":
    main()
