"""Re-prove the color-conversion exactness bound against the COMPILED kernel.

tools/check_color_risk.py proves the EPS bound for the f32 formula in host
NumPy; this tool closes the remaining gap (promised by ops/color.py's
docstring): it runs the jitted `ycbcr_to_rgb` on the current JAX backend
over the reachable input domain [-256,255]^3 — IDCT output is clipped
there (reference parser.cu:302-313) — and checks that every pixel either
matches the exact mixed-precision oracle (cpp color.cpp:8-19) bit-for-bit
or is flagged `risky`, i.e. the flag+host-repair contract holds for the
compiled kernel including any FMA contraction or reassociation the
compiler applied.

Usage:
    python tools/check_color_device.py             # full 512^3 domain
    python tools/check_color_device.py --stride 8  # every 8th Y slab

Exit code 0 iff no unflagged mismatch exists.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def prove(stride: int = 1, log=print) -> dict:
    """Run the check over every stride-th Y slab; returns the counts and
    the first unflagged mismatch (y, cb, cr, device, oracle) or None."""
    import jax
    import jax.numpy as jnp

    from tpujpeg.ops.color import ycbcr_to_rgb
    from tpujpeg.oracle import decoder as oracle

    span = np.arange(-256, 256, dtype=np.int32)          # 512 values
    cb, cr = np.meshgrid(span, span, indexing="ij")      # one [512,512] slab
    cb_d = jnp.asarray(cb)
    cr_d = jnp.asarray(cr)

    fn = jax.jit(ycbcr_to_rgb)
    checked = 0
    flagged = 0
    mismatch_unflagged = 0
    worst = None
    t0 = time.time()
    ys = list(range(-256, 256, stride))
    for i, yv in enumerate(ys):
        y_d = jnp.full(cb.shape, yv, jnp.int32)
        rgb_d, risky_d = fn(y_d, cb_d, cr_d)
        got = np.asarray(jax.device_get(rgb_d)).astype(np.int32)
        risky = np.asarray(jax.device_get(risky_d))
        exact = oracle.ycbcr_to_rgb_exact(
            np.full(cb.size, yv, np.int64), cb.ravel(), cr.ravel()
        ).reshape(cb.shape + (3,))
        diff = (got != exact).any(axis=-1)
        bad = diff & ~risky
        checked += diff.size
        flagged += int(risky.sum())
        if bad.any():
            mismatch_unflagged += int(bad.sum())
            if worst is None:
                j, k = np.argwhere(bad)[0]
                worst = (yv, int(cb[j, k]), int(cr[j, k]),
                         got[j, k].tolist(), exact[j, k].tolist())
        if i % 64 == 0:
            log(f"  slab y={yv:+4d}: flagged so far "
                f"{flagged}/{checked} ({100 * flagged / max(checked, 1):.3f}%)")
    return {
        "platform": jax.devices()[0].platform,
        "stride": stride,
        "checked": checked,
        "flagged": flagged,
        "flagged_share": flagged / checked,
        "unflagged_mismatches": mismatch_unflagged,
        "first_unflagged": worst,
        "seconds": time.time() - t0,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stride", type=int, default=1,
                    help="check every stride-th Y slab (1 = exhaustive)")
    args = ap.parse_args()

    from tpujpeg.utils.cache import compile_cache_dir

    compile_cache_dir()
    r = prove(args.stride)
    print(
        f"device={r['platform']} checked={r['checked']} "
        f"flagged={r['flagged']} ({100 * r['flagged_share']:.3f}%) "
        f"unflagged_mismatches={r['unflagged_mismatches']} "
        f"in {r['seconds']:.1f}s"
    )
    if r["first_unflagged"] is not None:
        print("WORST unflagged mismatch (y, cb, cr, device, oracle):",
              r["first_unflagged"])
        return 1
    print("PROOF HOLDS: every compiled-kernel deviation is risk-flagged.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
