"""Build the committed smoke corpus under corpus/smoke/ (run once, offline).

Content is the photo-mosaic recipe: random 320x320 crops (with flips) of
the repo's own fixture photos, tiled to the target size, encoded 4:4:4 at
q90 with libjpeg's standard tables.  Every image is fixed by its seed, so
rebuilding reproduces the same files byte for byte on the same encoder.

  rst_NN.jpg    16 x 640^2, one restart interval per MCU row
  norst_NN.jpg  the same 16 images with no restart markers
  big_2048.jpg  one 2048^2 image (256 MCU rows), one restart per MCU row
  dry_*.jpg     tiny uniform-noise streams for __graft_entry__'s sharded
                dry runs: dry_rst (32^2, a restart every MCU), dry_norst
                (32^2, none), dry_bucket (three geometries of one size
                class, a restart every MCU row), dry_scale (16 x 128^2, a
                restart every MCU)

The encoders (OpenCV, Pillow) are needed only here; readers of the corpus
(bench.py, chip_smoke.py, tests) need neither.

Usage: python tools/build_smoke_corpus.py
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpujpeg.utils.corpus import CORPUS_DIR, N_DISTINCT  # noqa: E402

QUALITY = 90
SIZE = 640
BIG = 2048
BIG_SEED = 123
TILE = 320


def photo_sources() -> list[np.ndarray]:
    """Fixture photos whose short side is at least one tile, so crops
    never upscale (upscaling smooths content and lowers bits/px)."""
    from PIL import Image

    out = []
    for p in sorted(glob.glob(os.path.join(ROOT, "tests/fixtures/*.jpg"))):
        im = Image.open(p).convert("RGB")
        if min(im.size) >= TILE:
            out.append(np.asarray(im))
    if not out:
        raise FileNotFoundError("no photo fixtures found")
    return out


def mosaic(srcs: list[np.ndarray], size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(10_000 + seed)
    nt = -(-size // TILE)
    canvas = np.empty((nt * TILE, nt * TILE, 3), np.uint8)
    for ty in range(nt):
        for tx in range(nt):
            src = srcs[int(rng.integers(len(srcs)))]
            h, w = src.shape[:2]
            y0 = int(rng.integers(h - TILE + 1))
            x0 = int(rng.integers(w - TILE + 1))
            t = src[y0 : y0 + TILE, x0 : x0 + TILE]
            if rng.random() < 0.5:
                t = t[:, ::-1]
            if rng.random() < 0.5:
                t = t[::-1]
            canvas[ty * TILE : (ty + 1) * TILE, tx * TILE : (tx + 1) * TILE] = t
    return canvas[:size, :size]


def encode(arr: np.ndarray, restart_rows: int, restart_mcus: int = 0) -> bytes:
    """Baseline 4:4:4 JPEG; restart_rows > 0 puts a DRI marker every that
    many MCU rows (interval rounded up so it stays row-aligned), or
    restart_mcus > 0 every that many MCUs."""
    import cv2

    flags = [
        cv2.IMWRITE_JPEG_QUALITY, QUALITY,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    ]
    interval = restart_mcus or restart_rows * ((arr.shape[1] + 7) // 8)
    if interval:
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, interval]
    ok, enc = cv2.imencode(".jpg", arr[:, :, ::-1], flags)
    if not ok:
        raise RuntimeError("OpenCV failed to encode")
    return enc.tobytes()


def main() -> int:
    srcs = photo_sources()
    os.makedirs(CORPUS_DIR, exist_ok=True)
    files = {}
    for i in range(N_DISTINCT):
        arr = mosaic(srcs, SIZE, i)
        files[f"rst_{i:02d}.jpg"] = encode(arr, 1)
        files[f"norst_{i:02d}.jpg"] = encode(arr, 0)
    files[f"big_{BIG}.jpg"] = encode(mosaic(srcs, BIG, BIG_SEED), 1)

    def noise(shape, seed):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, shape + (3,), dtype=np.uint8)

    for i in range(2):
        files[f"dry_rst_{i:02d}.jpg"] = encode(noise((32, 32), i), 0, 1)
        files[f"dry_norst_{i:02d}.jpg"] = encode(noise((32, 32), 2 + i), 0)
    for i, shape in enumerate([(32, 40), (30, 44), (25, 33)]):
        files[f"dry_bucket_{i:02d}.jpg"] = encode(noise(shape, i), 1)
    for i in range(16):
        files[f"dry_scale_{i:02d}.jpg"] = encode(noise((128, 128), i), 0, 1)
    for name, data in files.items():
        with open(os.path.join(CORPUS_DIR, name), "wb") as f:
            f.write(data)
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files, {total / 1e6:.2f} MB, to {CORPUS_DIR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
