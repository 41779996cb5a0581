"""Chroma upsampling: box (reference parity) and fancy (triangle filter).

The reference is 4:4:4-only and never upsamples (SURVEY §0); round 1
shipped box (sample replication) for subsampled streams, matching the
NumPy oracle.  This module adds libjpeg's *fancy* triangle upsampling
(jdsample.c h2v1/h2v2_fancy_upsample semantics) as a decode option — the
designed-for extension beyond the reference (PARITY.md, SURVEY §8
hard-part #5).

Semantics (integer-exact to libjpeg):
  - inputs are clamped JPEG samples in [0, 255] (the caller clamps the
    centered IDCT output with +128 first — libjpeg upsamples samples,
    not centered values, and the clamp changes results near saturation);
  - factor-2 horizontal: out[2i]   = (3*s[i] + s[i-1] + 1) >> 2
                         out[2i+1] = (3*s[i] + s[i+1] + 2) >> 2
    with edge replication (which degenerates to an exact copy at edges);
  - factor-2x2: vertical 3:1 column sums first (12-bit, unrounded), then
    the horizontal pass with biases 8 (even) / 7 (odd) and >> 4 — NOT two
    independent rounded passes;
  - other factors (4:1:1's 4x) fall back to box, as libjpeg does.

Everything is elementwise + static slicing + reshape: no gathers.  All
functions take the array namespace `xp` (jax.numpy on device, numpy in
the oracle/repair paths) so device and host share one definition —
there is nothing to drift.

Edge note: filters run over the full DCT-padded plane (static shapes under
jit), so replication happens at the padded edge, not the visible-image
edge; visible pixels never read padding except in the last sample column/
row pair, where libjpeg (which upsamples only `downsampled_width` samples)
can differ by a few levels.  The tolerance tests cover this.
"""

from __future__ import annotations

import jax.numpy as jnp


def _aslice(s, axis, start, stop):
    idx = [slice(None)] * s.ndim
    idx[axis] = slice(start, stop)
    return s[tuple(idx)]


def _edge_prev(s, axis, xp):
    return xp.concatenate(
        [_aslice(s, axis, 0, 1), _aslice(s, axis, 0, s.shape[axis] - 1)],
        axis=axis,
    )


def _edge_next(s, axis, xp, true_n=None):
    """Shift-left neighbor with edge replication.

    true_n (optional, a TRACED int scalar) moves the replication edge
    from the array's padded end to the image's true sample extent: in
    bucket-padded decode (pipeline.bucket_geometry) the plane extends
    past the real image with garbage blocks, and the triangle filter's
    last real output pair must read the clamped real neighbor — not a
    padding sample — to stay bit-identical to the exact-geometry decode.
    Positions at and past true_n produce garbage and get cropped.
    """
    nxt = xp.concatenate(
        [_aslice(s, axis, 1, None), _aslice(s, axis, s.shape[axis] - 1, None)],
        axis=axis,
    )
    if true_n is None:
        return nxt
    idx = xp.arange(s.shape[axis]).reshape(
        [s.shape[axis] if a == axis else 1 for a in range(s.ndim)]
    )
    return xp.where(idx == true_n - 1, s, nxt)


def _interleave(even, odd, axis, xp):
    stacked = xp.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _fancy_axis(s, axis, bias_even, bias_odd, shift, xp, true_n=None):
    """Triangle filter along one axis: 3:1 nearer:further, then >> shift."""
    prev = _edge_prev(s, axis, xp)
    nxt = _edge_next(s, axis, xp, true_n)
    even = (3 * s + prev + bias_even) >> shift
    odd = (3 * s + nxt + bias_odd) >> shift
    return _interleave(even, odd, axis, xp)


def fancy_upsample(s, fh: int, fv: int, xp=jnp, true_hw=None):
    """Triangle-upsample clamped samples [H, W] by (fh, fv) in {1, 2}.

    Exact libjpeg jdsample.c semantics: h2v1/h1v2 are a single rounded
    pass; h2v2 keeps the vertical 3:1 column sums unrounded (12-bit) and
    rounds once in the horizontal pass (biases 8/7, >> 4).

    true_hw: optional (true_h, true_w) TRACED int scalars giving the
    image's real sample extent inside a bucket-padded plane; the bottom/
    right replication edges move there (see _edge_next) so kept pixels
    match the exact-geometry decode bit for bit.
    """
    th, tw = true_hw if true_hw is not None else (None, None)
    if fh == 2 and fv == 2:
        up = _edge_prev(s, 0, xp)
        down = _edge_next(s, 0, xp, th)
        cs_even = 3 * s + up      # column sums for even output rows
        cs_odd = 3 * s + down     # ... and odd output rows

        def hpass(cs):
            return _fancy_axis(cs, 1, 8, 7, 4, xp, tw)

        return _interleave(hpass(cs_even), hpass(cs_odd), 0, xp)
    if fh == 2 and fv == 1:
        return _fancy_axis(s, 1, 1, 2, 2, xp, tw)
    if fh == 1 and fv == 2:
        return _fancy_axis(s, 0, 1, 2, 2, xp, th)
    if fh == 1 and fv == 1:
        return s
    raise ValueError(f"fancy upsampling only supports factors 1-2, got {fh}x{fv}")


def box_upsample(s, fh: int, fv: int, xp=jnp):
    """Sample-replication upsampling (the round-1/oracle behavior)."""
    if fh > 1:
        s = xp.repeat(s, fh, axis=1)
    if fv > 1:
        s = xp.repeat(s, fv, axis=0)
    return s


def upsample_plane(plane, fh: int, fv: int, fancy: bool, xp=jnp, true_hw=None):
    """Upsample a CENTERED int plane ([-256, 255] IDCT output) by (fh, fv).

    fancy=True clamps to samples first (libjpeg order: range-limit, then
    triangle filter), then re-centers; factors > 2 fall back to box either
    way.  fancy=False is bit-compatible with the round-1 box path.
    true_hw: traced real sample extents for bucket-padded planes (box
    replication is pointwise, so only the fancy path needs them).
    """
    if fh == 1 and fv == 1:
        return plane
    if fancy and fh <= 2 and fv <= 2:
        samples = xp.clip(plane + 128, 0, 255)
        return fancy_upsample(samples, fh, fv, xp, true_hw) - 128
    return box_upsample(plane, fh, fv, xp)
