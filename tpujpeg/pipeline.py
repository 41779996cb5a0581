"""Single-image decode pipeline: host entropy decode -> device kernels.

This is the device rendition of the reference's fused `decodeKernel`
(cuda-decoder/src/parser.cu:577-661): the four device stages (dequant +
inverse zigzag, IDCT rows, IDCT cols, color conversion) become one jitted
XLA program over dense coefficient arrays.  Entropy decoding happens on the
host (the cudaH strategy — the reference's fastest per-image variant,
legacy_versions/cudaH-implementation, BASELINE.md) until the device-side
segment-parallel decoder takes over for restart-interval streams.

Shapes are static per image geometry; the jit cache is keyed on a frozen
`Geometry` so repeated decodes of one size class compile once (SURVEY §8
hard-part #3: ragged shapes under jit are handled by size-class bucketing).

Bit-exactness: device math is exact for everything except a ~0.2% sliver of
color-conversion boundary cases, which the device flags into a 1-bit/pixel
mask and the host repairs with oracle math (see ops/color.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .constants import NATURAL_TO_ZIGZAG, ZIGZAG_TO_NATURAL
from .io.parser import JpegImage
from .ops.color import color_channels, pack_mask, unpack_mask
from .ops.idct import idct_planes
from .oracle import decoder as oracle


# ---------------------------------------------------------------------------
# Static geometry (jit cache key)
# ---------------------------------------------------------------------------


class Geometry(tuple):
    """Hashable static decode geometry.

    Layout: (width, height, mcus_x, mcus_y, comps) with comps a tuple of
    (h, v, quant_slot) per component, quant_slot indexing the [n_comp, 64]
    quant array passed to the device.
    """

    __slots__ = ()

    @staticmethod
    def of(img: JpegImage) -> "Geometry":
        comps = tuple((c.h, c.v, i) for i, c in enumerate(img.components))
        return Geometry(
            (img.width, img.height, img.mcus_x, img.mcus_y, comps)
        )

    width = property(lambda s: s[0])
    height = property(lambda s: s[1])
    mcus_x = property(lambda s: s[2])
    mcus_y = property(lambda s: s[3])
    comps = property(lambda s: s[4])

    @property
    def max_h(self) -> int:
        return max(c[0] for c in self.comps)

    @property
    def max_v(self) -> int:
        return max(c[1] for c in self.comps)

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v, _ in self.comps)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def n_blocks(self) -> int:
        return self.n_mcus * self.blocks_per_mcu

    def pattern(self) -> np.ndarray:
        out = []
        for ci, (h, v, _) in enumerate(self.comps):
            out.extend([ci] * (h * v))
        return np.array(out, dtype=np.int32)


# ---------------------------------------------------------------------------
# Size-class bucketing (recompile-free mixed-size decode)
# ---------------------------------------------------------------------------
#
# The reference decodes any image size with one compiled binary — dims are
# runtime values (cuda-decoder/src/parser.cu:324-331,624-626).  XLA needs
# static shapes, so heterogeneous-size corpora are decoded by snapping
# each image's MCU grid UP to a geometric ladder of bucket sizes: the
# coefficient tensor is zero-padded into the bucket's MCU raster, the
# pixel program compiles ONCE PER BUCKET (not per exact size), and the
# host crops the padded raster back to the true image.  The true MCU
# extents ride the jitted program as runtime scalars, driving the fancy
# upsampler's edge-replication masks so kept pixels stay bit-exact
# (SURVEY §8 hard-part #3).

_BUCKET_RATIO = 1.3  # ladder step; worst-case padded-area overhead 1.69x,
# expected ~1.3x; 200^2..2000^2 spans ~14 ladder values per axis


@functools.lru_cache(maxsize=None)
def bucket_up(n: int) -> int:
    """Smallest ladder value >= n (geometric ladder, base 4)."""
    b = 4
    while b < n:
        b = -(-b * 13 // 10)  # ceil(b * 1.3), exact in ints
    return b


def bucket_geometry(geom: Geometry) -> Geometry:
    """Snap a geometry's MCU grid up to its size-class bucket.

    Width/height are the bucket's FULL padded raster (no in-jit crop),
    so every exact geometry in the class shares one compiled program;
    callers crop fetched pixels to each image's true (height, width).
    """
    bx = bucket_up(geom.mcus_x)
    by = bucket_up(geom.mcus_y)
    return Geometry(
        (bx * 8 * geom.max_h, by * 8 * geom.max_v, bx, by, geom.comps)
    )


def pad_coeffs_to_bucket(
    geom: Geometry, bucket: Geometry, coeffs: np.ndarray, out: np.ndarray
) -> None:
    """Scatter real-layout coefficients into a bucket-layout row (host).

    Block order is MCU-raster, so each real MCU row lands at the same row
    of the bucket grid, followed by zero padding MCUs.  `out` must be a
    zeroed [bucket.n_blocks, 64] view.
    """
    bpm = geom.blocks_per_mcu
    view = out.reshape(bucket.mcus_y, bucket.mcus_x, bpm, 64)
    view[: geom.mcus_y, : geom.mcus_x] = coeffs.reshape(
        geom.mcus_y, geom.mcus_x, bpm, 64
    )


def unpad_coeffs_from_bucket(
    geom: Geometry, bucket: Geometry, out: np.ndarray
) -> np.ndarray:
    """Real-layout [n_blocks, 64] view of a bucket-layout row (host)."""
    bpm = geom.blocks_per_mcu
    view = out.reshape(bucket.mcus_y, bucket.mcus_x, bpm, 64)
    return np.ascontiguousarray(
        view[: geom.mcus_y, : geom.mcus_x]
    ).reshape(geom.n_blocks, 64)


# ---------------------------------------------------------------------------
# Device program
# ---------------------------------------------------------------------------


def _idct_planar(
    geom: Geometry, coeffs: jnp.ndarray, quant: jnp.ndarray,
    dc: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """dequant + inverse zigzag + IDCT in coefficient-major (SoA) layout.

    Returns [64, n_blocks] int32: row p = raster position p of every
    block, blocks ordered component-planar (all of comp 0, then 1, ...),
    mcu-major within a component.  Every op here keeps the long block axis
    minor (a multiple of 128 in practice), so elementwise passes run over
    contiguous memory; the AoS [..., 8, 8] form puts a length-8 axis
    minor.  The inverse zigzag is a STATIC reorder of the 64-plane axis
    instead of a per-element gather.

    dc (optional): int32 [n_blocks] of RESOLVED DC coefficients that
    override coeffs[:, 0].  The fused FSM chunk program leaves DPCM
    differences in the dense tensor and resolves them in a cheap [L, blk]
    cumsum; substituting the resolved plane here avoids re-writing the
    whole coefficient tensor just to update 1/64th of it.
    """
    coeffs = coeffs.astype(jnp.int32)
    per_mcu = coeffs.reshape(geom.n_mcus, geom.blocks_per_mcu, 64)
    dc_mcu = (
        None if dc is None
        else dc.reshape(geom.n_mcus, geom.blocks_per_mcu)
    )
    z2n = jnp.asarray(ZIGZAG_TO_NATURAL)
    soa = []
    base = 0
    for ci, (h, v, _) in enumerate(geom.comps):
        nb = h * v
        zp = per_mcu[:, base : base + nb, :].reshape(-1, 64).T  # [64, N_c]
        deq = zp * quant[ci][:, None]  # dequant in zigzag domain
        if dc_mcu is not None:
            dcc = dc_mcu[:, base : base + nb].reshape(-1)
            deq = jnp.concatenate(
                [(dcc * quant[ci, 0])[None, :], deq[1:]], axis=0
            )
        soa.append(jnp.take(deq, z2n, axis=0))
        base += nb
    return idct_planes(jnp.concatenate(soa, axis=1))


def _plane_from_soa(geom, pix_c: jnp.ndarray, h: int, v: int) -> jnp.ndarray:
    """[64, n_mcus*h*v] SoA pixels of one component -> raster plane."""
    grid = pix_c.reshape(8, 8, geom.mcus_y, geom.mcus_x, v, h)
    return grid.transpose(2, 4, 0, 3, 5, 1).reshape(
        geom.mcus_y * v * 8, geom.mcus_x * h * 8
    )


def decode_subsampled_planes(
    geom: Geometry, coeffs: jnp.ndarray, quant: jnp.ndarray,
    dc: jnp.ndarray | None = None,
) -> list[jnp.ndarray]:
    """Coefficients -> per-component CENTERED planes at native resolution.

    dequant (zigzag domain, cpp parser.cpp:111,130) + inverse zigzag +
    integer IDCT + block->raster; no upsampling yet — the stripe decoder
    injects a halo exchange between this stage and `upsample_planes`.
    """
    pix = _idct_planar(geom, coeffs, quant, dc)
    planes = []
    base = 0
    for h, v, _ in geom.comps:
        n = geom.n_mcus * h * v
        planes.append(_plane_from_soa(geom, pix[:, base : base + n], h, v))
        base += n
    return planes


def _decode_rgb_planar_fused(
    geom: Geometry, coeffs: jnp.ndarray, quant: jnp.ndarray,
    dc: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full-resolution (4:4:4 / grayscale) fast path: color in the SoA
    block domain, then ONE uint8 raster transpose.

    Color is pointwise, so converting before the block->raster reorder
    yields identical pixels; the reorder then moves uint8 instead of
    int32 planes.  Crop-after-color equals crop-before-color for the
    kept pixels, and `pack_mask` runs on the cropped mask, so riskbits
    match the plane path bit-for-bit.
    """
    pix = _idct_planar(geom, coeffs, quant, dc)  # [64, n_comp*n_mcus]
    n = geom.n_mcus
    if len(geom.comps) == 1:
        y, cb, cr = pix, jnp.zeros_like(pix), jnp.zeros_like(pix)
    else:
        y, cb, cr = pix[:, :n], pix[:, n : 2 * n], pix[:, 2 * n :]
    chans, risky = color_channels(y, cb, cr)
    rgb = jnp.stack(chans)  # [3, 64, n_mcus]
    rgb = (
        rgb.reshape(3, 8, 8, geom.mcus_y, geom.mcus_x)
        .transpose(0, 3, 1, 4, 2)
        .reshape(3, geom.mcus_y * 8, geom.mcus_x * 8)
    )
    risky = (
        risky.reshape(8, 8, geom.mcus_y, geom.mcus_x)
        .transpose(2, 0, 3, 1)
        .reshape(geom.mcus_y * 8, geom.mcus_x * 8)
    )
    rgb = rgb[:, : geom.height, : geom.width]
    return rgb, pack_mask(risky[: geom.height, : geom.width])


def upsample_planes(
    geom: Geometry, planes: list[jnp.ndarray], fancy: bool, extents=None
) -> list[jnp.ndarray]:
    """Native-resolution planes -> full-resolution planes (box or fancy).

    extents: optional traced (true_mcus_y, true_mcus_x) for bucket-padded
    decode — moves the fancy filter's bottom/right replication edges to
    the image's real sample extent (box replication is pointwise and
    needs nothing).
    """
    from .ops.upsample import upsample_plane

    return [
        upsample_plane(
            p, geom.max_h // h, geom.max_v // v, fancy,
            true_hw=(
                None if extents is None
                else (extents[0] * (v * 8), extents[1] * (h * 8))
            ),
        )
        for p, (h, v, _) in zip(planes, geom.comps)
    ]


def planes_to_rgb(
    geom: Geometry, planes: list[jnp.ndarray]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full-resolution planes -> (rgb uint8 PLANAR [3, H, W], riskbits).

    Channels stack on the LEADING axis, keeping a long minor dim (see
    _idct_planar); host boundaries interleave with one np.moveaxis.
    """
    if len(planes) == 1:
        y = planes[0][: geom.height, : geom.width]
        zeros = jnp.zeros_like(y)
        chans, risky = color_channels(y, zeros, zeros)
    else:
        y, cb, cr = (p[: geom.height, : geom.width] for p in planes)
        chans, risky = color_channels(y, cb, cr)
    return jnp.stack(chans), pack_mask(risky)


def device_decode_fn(
    geom: Geometry, coeffs: jnp.ndarray, quant: jnp.ndarray,
    fancy: bool = False, dc: jnp.ndarray | None = None, extents=None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The jittable decode body: coefficients -> (rgb uint8 planar
    [3, H, W], packed riskbits).

    coeffs: int32 or int16 [n_blocks, 64], zigzag order, scan order, DPCM
        resolved (int16 is lossless for conformant baseline scans and
        halves the host->device transfer; math still runs in int32).
    quant:  int32 [n_comp, 64], zigzag order.
    fancy:  libjpeg triangle chroma upsampling (subsampled streams only).
    dc:     optional int32 [n_blocks] resolved-DC override (see
        _idct_planar; used by the fused FSM chunk program).
    extents: optional traced (true_mcus_y, true_mcus_x) when `geom` is a
        size-class bucket (bucket_geometry) and the image only fills part
        of it — everything but the fancy upsampler's edge handling is
        per-block/per-pixel, so this is the only place true size matters.
    """
    if geom.max_h == 1 and geom.max_v == 1:
        # no upsampling needed: color in the block domain, one uint8
        # raster pass (the reference's 4:4:4-only contract lives here);
        # pointwise, so bucket padding needs no extents
        return _decode_rgb_planar_fused(geom, coeffs, quant, dc)
    planes = decode_subsampled_planes(geom, coeffs, quant, dc)
    return planes_to_rgb(geom, upsample_planes(geom, planes, fancy, extents))


@functools.lru_cache(maxsize=256)
def _compiled(geom: Geometry, fancy: bool = False):
    return jax.jit(functools.partial(device_decode_fn, geom, fancy=fancy))


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def build_plan(img: JpegImage) -> tuple[Geometry, np.ndarray, np.ndarray]:
    """Host side: entropy-decode the scan and pack device inputs."""
    from .runtime.host import entropy_decode

    coeffs = entropy_decode(img)
    quant = np.stack(
        [img.quant_tables[c.quant_id].astype(np.int32) for c in img.components]
    )
    return Geometry.of(img), coeffs, quant


def decode(img: JpegImage, strict: bool = True, fancy: bool = False) -> np.ndarray:
    """Decode one image on the device. Returns int32 [H, W, 3] RGB.

    strict=True repairs flagged color-boundary pixels with oracle math,
    guaranteeing bit-exact equality with the reference decoder (and, for
    fancy=True, with the NumPy fancy-upsampling oracle).
    """
    geom, coeffs, quant = build_plan(img)
    rgb_dev, riskbits = _compiled(geom, fancy)(
        jnp.asarray(coeffs), jnp.asarray(quant)
    )
    # device output is planar [3, H, W]; interleave at the host boundary
    rgb = np.ascontiguousarray(
        np.moveaxis(np.asarray(jax.device_get(rgb_dev)), 0, -1)
    ).astype(np.int32)
    if strict:
        packed = np.asarray(jax.device_get(riskbits))
        mask = unpack_mask(packed, img.width)
        if mask.any():
            _repair(img, coeffs, rgb, mask, fancy=fancy)
    return rgb


def _comp_samples(img, coeffs, quant_ci, comp_base_ci, c, cy, cx) -> np.ndarray:
    """Oracle IDCT sample values of one component at plane coords (cy, cx).

    Vectorized over pixel lists; cost is a few 8x8 IDCTs on the unique
    touched blocks.  Coordinates are in the component's own (subsampled)
    padded plane.
    """
    by, bx = cy // 8, cx // 8
    mcu = (by // c.v) * img.mcus_x + (bx // c.h)
    block_idx = (
        mcu * img.blocks_per_mcu + comp_base_ci + (by % c.v) * c.h + (bx % c.h)
    )
    uniq, inv = np.unique(block_idx, return_inverse=True)
    zz = coeffs[uniq].astype(np.int64) * quant_ci[None, :]
    natural = zz[:, ZIGZAG_TO_NATURAL].reshape(-1, 8, 8).astype(np.int32)
    pix = oracle.idct_blocks(natural)
    return pix[inv, cy % 8, cx % 8]


def _repair(
    img: JpegImage,
    coeffs: np.ndarray,
    rgb: np.ndarray,
    mask: np.ndarray,
    fancy: bool = False,
) -> None:
    """Recompute flagged pixels with exact oracle math, in place.

    Cost: a handful of vectorized 8x8 IDCTs on the unique touched blocks —
    O(flagged pixels), typically <0.1% of the image.  With fancy=True the
    chroma samples feeding the exact color math are rebuilt through the
    same triangle filter as the device (ops/upsample.py semantics).
    """
    py, px = np.nonzero(mask)
    comps = img.components
    max_h, max_v = img.max_h, img.max_v
    comp_base = np.cumsum([0] + [c.h * c.v for c in comps])
    quant = {i: img.quant_tables[c.quant_id].astype(np.int64) for i, c in enumerate(comps)}

    samples = []
    for ci, c in enumerate(comps):
        fy, fx = max_v // c.v, max_h // c.h
        val = functools.partial(
            _comp_samples, img, coeffs, quant[ci], comp_base[ci], c
        )
        if fy == 1 and fx == 1 or not fancy or fy > 2 or fx > 2:
            # box path (or full-res component): nearest sample
            samples.append(val(py // fy, px // fx))
            continue
        # fancy: rebuild the triangle filter from clamped samples
        hc = img.mcus_y * c.v * 8
        wc = img.mcus_x * c.h * 8
        r, col = py // fy, px // fx
        rn = np.clip(r + np.where(py % 2 == 1, 1, -1), 0, hc - 1) if fy == 2 else r
        cn = np.clip(col + np.where(px % 2 == 1, 1, -1), 0, wc - 1) if fx == 2 else col
        s = lambda rr, cc: np.clip(val(rr, cc) + 128, 0, 255).astype(np.int64)
        if fy == 2 and fx == 2:
            v = (
                9 * s(r, col) + 3 * s(r, cn) + 3 * s(rn, col) + s(rn, cn)
                + np.where(px % 2 == 1, 7, 8)
            ) >> 4
        elif fx == 2:
            v = (3 * s(r, col) + s(r, cn) + np.where(px % 2 == 1, 2, 1)) >> 2
        else:  # fy == 2
            v = (3 * s(r, col) + s(rn, col) + np.where(py % 2 == 1, 2, 1)) >> 2
        samples.append(v - 128)
    if len(comps) == 1:
        y = samples[0]
        cb = cr = np.zeros_like(y)
    else:
        y, cb, cr = samples
    exact = oracle.ycbcr_to_rgb_exact(y, cb, cr)
    rgb[py, px] = exact


def decode_file(path: str, strict: bool = True) -> np.ndarray:
    from .io.parser import parse_file

    return decode(parse_file(path), strict=strict)
