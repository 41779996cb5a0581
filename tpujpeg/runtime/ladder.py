"""Compile-ladder accounting: the bounded jit-key space of mixed-size
serving.

Every XLA program this engine compiles is keyed on static shapes.  The
reference serves any image size from one binary
(cuda-decoder/src/parser.cu:324-331); the XLA answer is a BOUNDED ladder
of compiled programs, and this module makes the bound explicit and
testable for a declared corpus envelope:

  * exact-geometry (uniform) chunks compile one fused program per
    distinct (geometry, stride-class, lane-count) — right for production
    corpora with a few fixed sizes (the reference's own datasets are
    size-bucketed, data_preprocessing/build_image_dataset.py);
  * mixed-size corpora route through size_buckets=True, whose fused
    program is keyed ONLY on (MCU-grid bucket, restart row-class k,
    byte-stride class): geometry variation rides runtime vectors
    (quotas/wrap/skip/extents), and round 5 pads partial chunks' lane
    counts to the full chunk's (fsm.build_plan_bucketed pad_imgs), so
    the remainder chunk of a batch reuses the full chunk's key instead
    of minting one per remainder size.

With a persistent compilation cache (JAX_COMPILATION_CACHE_DIR — set by
bench.py/conftest) the ladder is paid once per deployment, not per
process; tests/test_buckets.py::test_compile_ladder_bound asserts both
the enumeration and that real mixed corpora stay inside it.
"""

from __future__ import annotations

from ..ops import fsm
from ..pipeline import bucket_up


def stride_ladder(max_seg_bytes: int) -> tuple:
    """All reachable scan-stride classes for segments up to the bound.

    Mirrors fsm._stride_bucket: powers of two to 1 KiB, then 512-byte
    steps (coarser buckets would waste scan columns, which cost
    wall-clock serially).
    """
    out = []
    for s in (64, 128, 256, 512, 1024):
        out.append(s)
        if s >= max_seg_bytes:
            return tuple(out)
    s = 1536
    while s < max_seg_bytes + 512:
        out.append(s)
        s += 512
    return tuple(out)


def mcu_bucket_ladder(max_mcus: int) -> tuple:
    """All reachable bucket_up values (geometric ladder, ratio 1.3)."""
    out = [4]
    while out[-1] < max_mcus:
        out.append(bucket_up(out[-1] + 1))
    return tuple(out)


def bucketed_jit_keys(
    max_px: int,
    max_seg_bytes: int,
    k_values: tuple = (1,),
    mcu_px: int = 8,
    max_blk_cap: int = 512,
) -> list:
    """Enumerate every (bucket_mcus_x, bucket_mcus_y, k, stride) jit key
    the bucketed fused decoder can mint for a corpus envelope of images
    up to max_px on a side with restart segments up to max_seg_bytes.

    Buckets whose row capacity exceeds the materialize envelope
    (max_blk = k * bx * blocks_per_mcu > max_blk_cap blocks, i.e.
    max_blk*64 > 32768 dense rows) are excluded — the engine routes
    those to the host-bucketed path (runtime/batch.py), so they never
    compile.  Lane count and batch padding are derived from the key
    (pad_imgs), not part of it.
    """
    max_mcus = -(-max_px // mcu_px)
    grid = mcu_bucket_ladder(max_mcus)
    strides = stride_ladder(max_seg_bytes)
    keys = []
    for k in k_values:
        for bx in grid:
            if k * bx * 3 > max_blk_cap:   # 4:4:4: 3 blocks/MCU
                continue
            for by in grid:
                for s in strides:
                    keys.append((bx, by, k, s))
    return keys


def observed_key(plan: fsm.FsmBucketPlan, bucket) -> tuple:
    """The ladder key a packed bucket plan will compile under."""
    return (
        bucket.mcus_x, bucket.mcus_y, plan.k, plan.xs.shape[1],
    )
