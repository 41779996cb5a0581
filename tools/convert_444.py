"""Re-encode images as baseline 4:4:4 JPEG, optionally with restart markers.

Parity with the reference's data_preprocessing/image_converter.py:6-22
(which shells out to simplejpeg to force 4:4:4), plus the one option that
matters most for the device decoder: `--rst-rows N` writes a DRI marker every N MCU rows.
Restart markers are what make entropy decode parallel — on the host
(OpenMP across segments) and on the device (FSM lanes) — at ~1-3% size
overhead.  Use this to prepare datasets for tpujpeg the way the reference
prepared its 4:4:4-only datasets.

  python tools/convert_444.py IN_DIR OUT_DIR --quality 90 --rst-rows 1
"""

from __future__ import annotations

import argparse
import os
import sys


def convert_file(src: str, dst: str, quality: int, rst_rows: int) -> bool:
    import cv2

    img = cv2.imread(src, cv2.IMREAD_COLOR)
    if img is None:
        return False
    flags = [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    ]
    if rst_rows > 0:
        mcus_x = -(-img.shape[1] // 8)
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst_rows * mcus_x]
    return bool(cv2.imwrite(dst, img, flags))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument(
        "--rst-rows", type=int, default=1,
        help="restart interval in MCU rows (0 disables restart markers)",
    )
    args = ap.parse_args(argv)

    os.makedirs(args.dst_dir, exist_ok=True)
    n_ok = n_fail = 0
    for name in sorted(os.listdir(args.src_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".ppm")):
            continue
        dst = os.path.join(args.dst_dir, os.path.splitext(name)[0] + ".jpg")
        if convert_file(os.path.join(args.src_dir, name), dst,
                        args.quality, args.rst_rows):
            n_ok += 1
        else:
            n_fail += 1
            print(f"failed: {name}", file=sys.stderr)
    print(f"converted {n_ok} images ({n_fail} failures) -> {args.dst_dir}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
