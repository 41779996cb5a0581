"""Manifest-driven bulk decode with resume: decode a directory of JPEGs.

The aux-subsystem the reference lacks (SURVEY §6 checkpoint/resume:
"batch manifest/resume for 10k-image runs"): progress is journaled to a
manifest JSONL, so an interrupted run picks up where it left off, failed
images are recorded (not fatal), and per-image timings feed the
observability pipeline.

  python tools/batch_decode.py IN_DIR OUT_DIR [--backend host] [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src_dir")
    ap.add_argument("dst_dir")
    ap.add_argument("--backend", default="host",
                    choices=["auto", "host", "fsm", "oracle"])
    ap.add_argument("--format", default="array", choices=["array", "png"],
                    help="png needs Pillow")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--size-buckets", action="store_true",
                    help="group images by size-class bucket instead of "
                         "exact geometry: bounded compile count on "
                         "mixed-size corpora (host-capable backends)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--manifest", default=None)
    args = ap.parse_args(argv)

    from PIL import Image

    from tpujpeg.io.arrayio import write_array
    from tpujpeg.runtime.batch import BatchDecoder
    from tpujpeg.utils.cache import compile_cache_dir

    compile_cache_dir()

    os.makedirs(args.dst_dir, exist_ok=True)
    manifest_path = args.manifest or os.path.join(args.dst_dir, "manifest.jsonl")
    done: set[str] = set()
    if args.resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("status") == "ok":
                    done.add(rec["name"])

    names = [
        n for n in sorted(os.listdir(args.src_dir))
        if n.lower().endswith((".jpg", ".jpeg")) and n not in done
    ]
    if done:
        print(f"resume: {len(done)} already done, {len(names)} remaining")

    dec = BatchDecoder(
        backend=args.backend, chunk_size=args.chunk,
        size_buckets=args.size_buckets,
    )
    manifest = open(manifest_path, "a")
    n_ok = n_fail = 0
    for j in range(0, len(names), args.chunk):
        part = names[j : j + args.chunk]
        datas = [open(os.path.join(args.src_dir, n), "rb").read() for n in part]
        t0 = time.perf_counter()
        results = dec.decode(datas, on_error="skip")
        dt = time.perf_counter() - t0
        for name, rgb in zip(part, results):
            if rgb is None:
                rec = {"name": name, "status": "error",
                       "error": dec.stats.failures.get(part.index(name), "decode failed")}
                n_fail += 1
            else:
                stem = os.path.splitext(name)[0]
                if args.format == "png":
                    out = os.path.join(args.dst_dir, stem + ".png")
                    Image.fromarray(rgb).save(out)
                else:
                    out = os.path.join(args.dst_dir, stem + ".array")
                    write_array(out, rgb)
                rec = {"name": name, "status": "ok", "out": out,
                       "ms": round(dt / len(part) * 1e3, 2)}
                n_ok += 1
            manifest.write(json.dumps(rec) + "\n")
        manifest.flush()
        print(f"[{j + len(part)}/{len(names)}] chunk in {dt*1e3:.0f} ms "
              f"({dec.stats.backend})", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed -> {manifest_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
