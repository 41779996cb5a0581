"""Stage times of the production fused chunk program, two ways.

1. Cumulative cuts: the REAL fused program (runtime/fused.py) compiled
   truncated after each stage, with a checksum fence that consumes the
   stage's full output (a fence on a slice lets XLA dead-code-eliminate
   the buffers the real program must materialize); consecutive
   differences are each stage's cost inside the production program.
2. A jax.profiler trace of the full program: every device kernel is
   attributed to the named scope (fsm_scan, materialize, assemble,
   pixels) of its HLO instruction (the compiled HLO's op_name metadata,
   else the event's own `name` stat), and the union of kernel intervals
   gives device busy time.

The chunk is --images copies of the committed restart corpus (640^2 q90
4:4:4, one restart interval per MCU row).  Prints one JSON line naming
the device; --out also writes it to a file.

Usage: python tools/profile_fused.py [--images 128] [--iters 10]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SCOPES = ("fsm_scan", "materialize", "assemble", "pixels")


def _card() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _timed(fn, iters: int) -> dict:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return {"median_ms": float(np.median(ts)) * 1e3,
            "min_ms": float(np.min(ts)) * 1e3}


def _scope_of_path(path: str) -> str:
    return next(
        (s for s in SCOPES if f"/{s}/" in path or path.endswith(f"/{s}")),
        "other",
    )


def scope_map(hlo_text: str) -> dict:
    """HLO instruction name -> named scope, from op_name metadata."""
    pat = r"%?([\w.\-]+) = [^\n]*metadata=\{[^}]*op_name=\"([^\"]+)\""
    return {m.group(1): _scope_of_path(m.group(2))
            for m in re.finditer(pat, hlo_text)}


def reduce_trace(xplane: str, scopes: dict, n_runs: int) -> dict:
    """Device kernel time per scope (ms per run) and device busy share.

    Events map through `scopes` by their `hlo_op` stat, else through
    their `name` stat (an op_name path); `events_with_stat` counts how
    many events carried each, and `unattributed_ops` names a few events
    that matched no scope, so a change in the trace format shows."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane)
    by_scope: dict[str, float] = {}
    keys: dict[str, int] = {}
    unmatched: set[str] = set()
    spans = []
    for plane in pd.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                st = {str(k): v for k, v in ev.stats}
                for k in ("name", "hlo_op"):
                    keys[k] = keys.get(k, 0) + (k in st)
                sc = scopes.get(str(st.get("hlo_op", ev.name)))
                if sc is None and "name" in st:
                    sc = _scope_of_path(str(st["name"]))
                if sc is None and len(unmatched) < 5:
                    unmatched.add(str(st.get("hlo_op", ev.name)))
                sc = sc or "unattributed"
                by_scope[sc] = by_scope.get(sc, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return {
        "kernel_ms_per_run": {k: v / n_runs / 1e6
                              for k, v in sorted(by_scope.items())},
        "device_busy_ms_per_run": busy / n_runs / 1e6,
        "device_idle_share": 1 - busy / window if window else None,
        "kernels": len(spans),
        "events_with_stat": keys,
        "unattributed_ops": sorted(unmatched),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace-runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpujpeg.io.parser import parse
    from tpujpeg.ops import fsm
    from tpujpeg.pipeline import Geometry
    from tpujpeg.runtime import fused
    from tpujpeg.utils import corpus
    from tpujpeg.utils.cache import compile_cache_dir

    compile_cache_dir()
    imgs =[parse(d) for d in corpus.tile(corpus.load("rst"), args.images)]
    geom = Geometry.of(imgs[0])
    plan = fsm.build_plan(imgs, split=False)
    xs, sn = plan.groups[0]
    up = (jax.device_put(jnp.asarray(xs)), jax.device_put(jnp.asarray(sn)))
    quant = jnp.asarray(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32))

    def program(stop_after):
        return fused.compiled_fused_decoder(
            geom, plan.tables, plan.max_blk, plan.layout, args.images,
            want_coeffs=False, stop_after=stop_after,
        )

    cuts = {}
    for cut in ("scan", "materialize", "assemble", None):
        fn = program(cut)
        cuts[cut or "full"] = _timed(lambda: fn(*up, quant), args.iters)

    # On the GPU XLA runs the program as CUDA-graph command buffers, and
    # the trace names every kernel inside one "command_buffer".  The
    # traced copy is compiled without them, so each kernel is launched,
    # and named, on its own: its kernel times are the production
    # program's, its launch gaps (and so its idle share) are not.
    full = program(None).lower(*up, quant).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""}
    )
    scopes = scope_map(full.as_text())
    tdir = tempfile.mkdtemp(prefix="profile_fused_")
    try:
        jax.block_until_ready(full(*up, quant))
        jax.profiler.start_trace(tdir)
        for _ in range(args.trace_runs):
            jax.block_until_ready(full(*up, quant))
        jax.profiler.stop_trace()
        xplane = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                                  recursive=True))[-1]
        trace = reduce_trace(xplane, scopes, args.trace_runs)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    dev = jax.devices()[0]
    rec = {
        "tool": "profile_fused",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": _card(),
        "chunk": {"images": args.images, "size": f"{geom.width}x{geom.height}",
                  "lanes": int(xs.shape[0]), "stride": int(xs.shape[1]),
                  "max_blk": plan.max_blk},
        "cumulative_cuts": cuts,
        "hlo_ops_with_scope": len(scopes),
        "trace": trace,
    }
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
