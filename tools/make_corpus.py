#!/usr/bin/env python3
"""Generate the synthetic PNG conformance corpus.

The real qoi_benchmark_suite (~2,800 PNGs, linked from the reference
README) is not downloaded; this corpus mirrors its content classes —
3-channel-photo-heavy, like the real suite — with the repo's generators
at a spread of sizes, seeds and channel counts, deterministically:
~320 images incl. extreme aspect ratios (1xN / Nx1), >= 16 Mpx members,
hash-collision-dense palettes and worst-case ~5 B/px noise.

    python tools/make_corpus.py /tmp/qoi_corpus            # full (~320)
    python tools/make_corpus.py /tmp/qoi_corpus --small    # legacy 32
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from qoi_tpu import io as qio  # noqa: E402
from qoi_tpu.utils import testimages as t  # noqa: E402


def _small_specs():
    specs = []
    # photo/texture-like (constant alpha — the suite's dominant class)
    for i, (w, h) in enumerate([(640, 480), (800, 600), (1024, 768),
                                (1920, 1080), (333, 777), (64, 64)]):
        specs.append((f"photo/photo_{w}x{h}.png", t.photo(w, h, 3, seed=i)))
        specs.append((f"photo/photo_{w}x{h}_rgba.png",
                      t.photo(w, h, 4, seed=i + 50)))
    # icon-like (small, varying alpha)
    for i, s in enumerate([16, 32, 48, 64, 128]):
        specs.append((f"icons/icon_{s}.png", t.mixed(s, s, 4, seed=i)))
        specs.append((f"icons/alpha_{s}.png", t.alpha_toggle(s, s, seed=i)))
    # screenshot-like (flat regions + palette bands)
    for i, (w, h) in enumerate([(1280, 720), (640, 400)]):
        specs.append((f"screens/flat_{w}x{h}.png", t.flat(w, h, 3)))
        specs.append((f"screens/palette_{w}x{h}.png",
                      t.palette(w, h, 3, colors=12, seed=i)))
        specs.append((f"screens/gradient_{w}x{h}.png", t.gradient(w, h, 3)))
    # pathological
    specs.append(("hard/noise_512.png", t.noise(512, 512, 4, seed=9)))
    specs.append(("hard/wrap_256.png", t.wraparound(256, 64, 4)))
    specs.append(("hard/tall_1xN.png", t.gradient(1, 4096, 3)))
    specs.append(("hard/wide_Nx1.png", t.gradient(4096, 1, 3)))
    return specs


def _full_specs():
    specs = []
    # --- photo class, 3-channel-heavy (the real suite's shape) -------
    photo_sizes = [(160, 120), (320, 240), (400, 300), (512, 384),
                   (640, 480), (735, 551), (800, 600), (1024, 768),
                   (1111, 763), (1280, 960), (1600, 1200), (1920, 1080),
                   (257, 1023), (1023, 257), (96, 96)]
    for i, (w, h) in enumerate(photo_sizes):
        for s in range(10):
            specs.append((f"photo/photo_{w}x{h}_s{s}.png",
                          t.photo(w, h, 3, seed=16 * i + s)))
    for i, (w, h) in enumerate(photo_sizes[:10]):
        for s in range(4):
            specs.append((f"photo_rgba/photo_{w}x{h}_s{s}.png",
                          t.photo(w, h, 4, seed=100 + 16 * i + s)))
    # --- icon class (small, varying alpha) ---------------------------
    for i, sz in enumerate([16, 32, 48, 64, 128, 192, 256]):
        for s in range(3):
            specs.append((f"icons/icon_{sz}_s{s}.png",
                          t.mixed(sz, sz, 4, seed=8 * i + s)))
        specs.append((f"icons/alpha_{sz}.png",
                      t.alpha_toggle(sz, sz, seed=i)))
    # --- screenshot class (flat / palette / gradient) ----------------
    for i, (w, h) in enumerate([(1280, 720), (1024, 600), (800, 480),
                                (640, 400), (1920, 1080), (360, 740),
                                (273, 414), (2048, 128), (555, 555),
                                (1366, 768)]):
        specs.append((f"screens/flat_{w}x{h}.png", t.flat(w, h, 3)))
        specs.append((f"screens/palette_{w}x{h}.png",
                      t.palette(w, h, 3, colors=8 + 4 * i, seed=i)))
        specs.append((f"screens/gradient_{w}x{h}.png", t.gradient(w, h, 3)))
        specs.append((f"screens/mixed_{w}x{h}.png",
                      t.mixed(w, h, 3, seed=200 + i)))
    # --- hash-collision-dense palettes (every color -> one slot) -----
    for i, slot in enumerate([0, 17, 63]):
        for ch in (3, 4):
            specs.append((f"hard/collide_s{slot}_{ch}ch.png",
                          t.palette_collide(512, 256, ch, colors=24,
                                            seed=300 + i, slot=slot)))
    for i in range(4):
        specs.append((f"hard/collide_dense_{i}.png",
                      t.palette_collide(777, 333, 4, colors=64,
                                        seed=310 + i, slot=i * 13 % 64)))
    # --- palette_alpha (the fallback-ladder class) -------------------
    for i in range(6):
        specs.append((f"hard/palette_alpha_{i}.png",
                      t.palette_alpha(256 + 64 * i, 200,
                                      colors=16 + 8 * i, seed=400 + i)))
    # --- worst-case literal density (~4-5 B/px) ----------------------
    for i, (w, h) in enumerate([(512, 512), (333, 777), (1024, 512)]):
        specs.append((f"hard/noise_rgb_{w}x{h}.png",
                      t.noise(w, h, 3, seed=500 + i)))
        specs.append((f"hard/noise_rgba_{w}x{h}.png",
                      t.noise(w, h, 4, seed=510 + i)))
    # --- extreme aspect ratios ---------------------------------------
    for n in (1, 7, 64, 333, 4096, 16384):
        specs.append((f"aspect/wide_{n}x1.png", t.gradient(n, 1, 3)))
        specs.append((f"aspect/tall_1x{n}.png", t.gradient(1, n, 3)))
    specs.append(("aspect/wide_noise_8192x2.png", t.noise(8192, 2, 4, 600)))
    specs.append(("aspect/tall_palette_3x30000.png",
                  t.palette(3, 30000, 3, colors=11, seed=601)))
    # --- large members (>= 16 Mpx: the real suite's big-photo role) --
    specs.append(("big/photo_5120x3200_rgb.png",      # 16.38 Mpx
                  t.photo(5120, 3200, 3, seed=700)))
    specs.append(("big/mixed_4800x3600_rgba.png",     # 17.28 Mpx
                  t.mixed(4800, 3600, 4, seed=701)))
    specs.append(("big/photo_3840x2160_rgba.png",     # 8.29 Mpx
                  t.photo(3840, 2160, 4, seed=702)))
    # --- remaining pathological members ------------------------------
    specs.append(("hard/wrap_256.png", t.wraparound(256, 64, 4)))
    specs.append(("hard/wrap_rgb.png", t.wraparound(640, 31, 3)))
    specs.append(("hard/runs_caps.png", t.runs_with_caps(130, 30, 4)))
    specs.append(("hard/runs_caps_rgb.png", t.runs_with_caps(260, 15, 3)))
    specs.append(("hard/seed_run.png", t.seed_run_start(128, 128, 4)))
    specs.append(("hard/seed_run_rgb.png", t.seed_run_start(64, 256, 3)))
    return specs


def build(root: pathlib.Path, small: bool = False) -> int:
    specs = _small_specs() if small else _full_specs()
    mpx = 0
    for rel, img in specs:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        qio.save_png(p, img)
        mpx += img.shape[0] * img.shape[1]
    print(f"total {mpx/1e6:.1f} Mpx")
    return len(specs)


if __name__ == "__main__":
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "/tmp/qoi_corpus")
    n = build(root, small="--small" in sys.argv)
    print(f"{n} PNGs under {root}")
