"""Command-line interface.

Replaces the reference's hardcoded-path drivers (`main.cu:7-40`, output dir
baked into `write()`, parser.cu:732) with a proper CLI:

  python -m tpujpeg.cli decode IMG.jpg -o OUT.array [--backend device|cpu|oracle]
  python -m tpujpeg.cli info IMG.jpg
  python -m tpujpeg.cli compare OUT.array GOLDEN.array [--tolerance N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_decode(args) -> int:
    import numpy as np

    from .io.arrayio import write_array
    from .io.parser import parse_file

    img = parse_file(args.input)
    t0 = time.perf_counter()
    backend = args.backend
    if backend == "auto":
        # single-image latency routing (see tpujpeg.decode): native C++
        # when available — one image cannot amortize a device dispatch
        from .runtime import host as _host

        backend = "cpu" if _host._load_native() is not None else "device"
    if backend == "oracle":
        from .oracle import decoder as oracle

        rgb = oracle.decode(img, fancy=args.fancy_upsampling)
    elif backend == "cpu":
        from .runtime import host

        rgb = host.decode_cpu(img, fancy=args.fancy_upsampling)
    else:
        from . import pipeline

        rgb = pipeline.decode(
            img, strict=not args.fast, fancy=args.fancy_upsampling
        )
    dt = time.perf_counter() - t0

    out = args.output
    if out is None:
        out = args.input.rsplit(".", 1)[0] + ".array"
    if out.endswith(".array"):
        write_array(out, rgb)
    elif out.endswith((".png", ".bmp", ".ppm")):
        from PIL import Image

        Image.fromarray(np.asarray(rgb, dtype=np.uint8)).save(out)
    else:
        raise SystemExit(f"unsupported output format: {out}")
    if not args.quiet:
        print(
            f"{args.input}: {img.width}x{img.height} {img.sampling} "
            f"-> {out} in {dt*1e3:.1f} ms"
        )
    return 0


def _cmd_info(args) -> int:
    from .io.parser import parse_file

    img = parse_file(args.input)
    info = {
        "path": args.input,
        "width": img.width,
        "height": img.height,
        "sampling": img.sampling,
        "precision": img.precision,
        "components": len(img.components),
        "restart_interval": img.restart_interval,
        "entropy_segments": img.n_segments(),
        "mcus": [img.mcus_x, img.mcus_y],
        "blocks_per_mcu": img.blocks_per_mcu,
        "scan_bytes": int(img.scan_data.size),
        "quant_tables": sorted(img.quant_tables),
        "huffman_tables": [hex(h) for h in sorted(img.huffman)],
    }
    print(json.dumps(info, indent=2))
    return 0


def _cmd_compare(args) -> int:
    """Golden comparator (reference testing/compare.py:37-64 semantics)."""
    import numpy as np

    from .io.arrayio import read_array

    a = read_array(args.a)
    b = read_array(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 1
    diff = np.abs(a - b)
    if diff.max() <= args.tolerance:
        print(f"MATCH (max diff {int(diff.max())}, tolerance {args.tolerance})")
        return 0
    print(
        f"MISMATCH: max diff {int(diff.max())}, "
        f"{int((diff > args.tolerance).sum())} px over tolerance"
    )
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpujpeg")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode a JPEG to .array/.png")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None)
    d.add_argument(
        "--backend", choices=["auto", "device", "cpu", "oracle"],
        default="auto",
        help="auto = native C++ when available (single decodes cannot "
             "amortize a device dispatch; both paths are bit-exact); "
             "device = device pipeline; cpu = force the native C++ decoder "
             "(entropy + pixels, OpenMP); oracle = NumPy reference",
    )
    d.add_argument(
        "--fast",
        action="store_true",
        help="skip the strict bit-exact color repair pass",
    )
    d.add_argument(
        "--fancy-upsampling",
        action="store_true",
        help="libjpeg-style triangle chroma upsampling for subsampled "
        "streams (default: box replication)",
    )
    d.add_argument("-q", "--quiet", action="store_true")
    d.set_defaults(fn=_cmd_decode)

    i = sub.add_parser("info", help="print stream metadata as JSON")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)

    c = sub.add_parser("compare", help="compare two .array files")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tolerance", type=int, default=0)
    c.set_defaults(fn=_cmd_compare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
