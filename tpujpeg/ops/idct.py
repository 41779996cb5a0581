"""Integer 8x8 inverse DCT as a vectorized XLA computation.

Bit-identical to the reference's fixed-point IDCT (cpp-decoder/src/idct.cpp:
33-133, cuda-decoder/src/parser.cu:218-314): row pass scales by 2^11 and
shifts right 8, column pass scales by 2^8, shifts right 14, and clips to
[-256, 255].  All arithmetic is int32 — the same width the reference uses —
so any overflow wraps identically.

Device mapping: the butterflies are pure elementwise int32 ops over [N, 8]
column/row slices, which XLA vectorizes across the block axis.  There is
no matmul here on purpose: a float matrix IDCT could not reproduce the
reference's shift/truncation rounding (SURVEY §8 hard-part #1).

The reference's zero-AC "shortcut" blocks (cpp idct.cpp:38-41,83-85) are
arithmetically equal to the general butterflies (proved in
tests/test_oracle.py::test_idct_dc_only), so the vectorized general path is
used unconditionally — which also matches the CUDA variant that removed the
branch to avoid divergence (reference README.md:186).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import C1, C2, C3, C5, C6, C7


def _rowpass(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = (x0 << 11) + 128
    x1 = x1 << 11
    x8 = C7 * (x4 + x5)
    x4 = x8 + (C1 - C7) * x4
    x5 = x8 - (C1 + C7) * x5
    x8 = C3 * (x6 + x7)
    x6 = x8 - (C3 - C5) * x6
    x7 = x8 - (C3 + C5) * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C6 * (x3 + x2)
    x2 = x1 - (C2 + C6) * x2
    x3 = x1 + (C2 - C6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    return (
        (x7 + x1) >> 8,
        (x3 + x2) >> 8,
        (x0 + x4) >> 8,
        (x8 + x6) >> 8,
        (x8 - x6) >> 8,
        (x0 - x4) >> 8,
        (x3 - x2) >> 8,
        (x7 - x1) >> 8,
    )


def _colpass(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = (x0 << 8) + 8192
    x1 = x1 << 8
    x8 = C7 * (x4 + x5) + 4
    x4 = (x8 + (C1 - C7) * x4) >> 3
    x5 = (x8 - (C1 + C7) * x5) >> 3
    x8 = C3 * (x6 + x7) + 4
    x6 = (x8 - (C3 - C5) * x6) >> 3
    x7 = (x8 - (C3 + C5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C6 * (x3 + x2) + 4
    x2 = (x1 - (C2 + C6) * x2) >> 3
    x3 = (x1 + (C2 - C6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    clip = lambda v: jnp.clip(v, -256, 255)
    return (
        clip((x7 + x1) >> 14),
        clip((x3 + x2) >> 14),
        clip((x0 + x4) >> 14),
        clip((x8 + x6) >> 14),
        clip((x8 - x6) >> 14),
        clip((x0 - x4) >> 14),
        clip((x3 - x2) >> 14),
        clip((x7 - x1) >> 14),
    )


def idct_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """Two-pass integer IDCT over [..., 8, 8] int32 blocks."""
    b = blocks.astype(jnp.int32)
    cols = [b[..., :, k] for k in range(8)]
    r = _rowpass(cols[0], cols[4], cols[6], cols[2], cols[1], cols[7], cols[5], cols[3])
    b = jnp.stack(r, axis=-1)
    rows = [b[..., k, :] for k in range(8)]
    r = _colpass(rows[0], rows[4], rows[6], rows[2], rows[1], rows[7], rows[5], rows[3])
    return jnp.stack(r, axis=-2)


def idct_planes(planes64: jnp.ndarray) -> jnp.ndarray:
    """IDCT in coefficient-major (structure-of-arrays) layout.

    `planes64` is [..., 64, N]: row p holds natural-order coefficient p of N
    blocks, so the long block axis stays minor (pipeline._idct_planar).
    """
    x = planes64.astype(jnp.int32)
    rows = []
    for rr in range(8):
        c = [x[..., 8 * rr + k, :] for k in range(8)]
        rows.append(
            _rowpass(c[0], c[4], c[6], c[2], c[1], c[7], c[5], c[3])
        )
    out = [None] * 64
    for cc in range(8):
        col_in = [rows[k][cc] for k in range(8)]
        res = _colpass(
            col_in[0], col_in[4], col_in[6], col_in[2],
            col_in[1], col_in[7], col_in[5], col_in[3],
        )
        for rr in range(8):
            out[8 * rr + cc] = res[rr]
    return jnp.stack(out, axis=-2)
