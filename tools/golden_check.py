"""Golden-output validation: decode every fixture, compare to goldens.

Parity with the reference's testing/compare.py:37-89 workflow (run decoder
per image, diff against ground_truth/ exactly, print max diff on failure)
without the subprocess round-trip: the decoder is called in-process.

  python tools/golden_check.py [--backend device|cpu|oracle|batch] [--images DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="device",
                    choices=["device", "cpu", "oracle", "batch"])
    ap.add_argument(
        "--images",
        default=os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures"),
    )
    ap.add_argument("--tolerance", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    import tpujpeg
    from tpujpeg.io.arrayio import read_array

    names = sorted(
        f[:-4]
        for f in os.listdir(args.images)
        if f.endswith(".jpg")
        and os.path.exists(os.path.join(args.images, f[:-4] + ".array"))
    )
    if not names:
        print("no fixture pairs found", file=sys.stderr)
        return 2

    failures = 0
    for name in names:
        jpg = os.path.join(args.images, name + ".jpg")
        golden = read_array(os.path.join(args.images, name + ".array"))
        if args.backend == "batch":
            with open(jpg, "rb") as f:
                rgb = tpujpeg.decode_batch([f.read()])[0].astype(np.int32)
        else:
            rgb = np.asarray(tpujpeg.decode(jpg, backend=args.backend))
        diff = int(np.abs(rgb - golden).max()) if rgb.shape == golden.shape else 256
        ok = rgb.shape == golden.shape and diff <= args.tolerance
        print(f"{name}: {'MATCH' if ok else f'MISMATCH (max diff {diff})'}")
        failures += 0 if ok else 1
    print(f"{len(names) - failures}/{len(names)} matched")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
