"""The XLA pixel path (pipeline._decode_rgb_planar_fused) against the oracle.

Full-resolution streams take the block-domain fast path: dequant, DC
substitution, integer IDCT and colour over [64, n_mcus] planes, then one
uint8 raster transpose.  These tests pin it against the NumPy oracle on
real streams and adversarial coefficient tensors, against the plane path
it shortcuts, with the resolved-DC side channel, and under vmap.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpujpeg import pipeline
from tpujpeg.io.parser import parse
from tpujpeg.ops.color import unpack_mask
from tpujpeg.oracle import decoder as oracle

from conftest import make_jpeg


def _oracle_pixels(img, coeffs):
    """Oracle pixel stage over given zigzag coefficients -> int32 HWC."""
    natural = oracle.dequantize(img, np.asarray(coeffs, np.int32))
    planes = oracle.assemble_planes(img, oracle.idct_blocks(natural))
    y, cb, cr = (p[: img.height, : img.width] for p in planes)
    return oracle.ycbcr_to_rgb_exact(y, cb, cr)


def _assert_exact_outside_risk(geom, out, want):
    """Unflagged pixels equal the oracle; flagged ones are what strict
    repair recomputes (ops/color.py)."""
    rgb = np.moveaxis(np.asarray(out[0]), 0, -1)
    safe = ~unpack_mask(np.asarray(out[1]), geom.width)
    np.testing.assert_array_equal(rgb[safe], want[safe])


@pytest.mark.parametrize("shape", [(48, 64), (64, 128), (225, 168)])
def test_pixels_match_oracle_on_streams(shape):
    img = parse(make_jpeg(shape=shape, quality=85, seed=3))
    geom, coeffs, quant = pipeline.build_plan(img)
    out = pipeline._decode_rgb_planar_fused(
        geom, jnp.asarray(coeffs), jnp.asarray(quant)
    )
    _assert_exact_outside_risk(geom, out, oracle.decode(img))


def test_pixels_dc_side_channel():
    # the fused chunk program passes DPCM diffs in coeffs[:, 0] and the
    # resolved DC on the side channel: the override must equal writing
    # the DC plane into the coefficients
    img = parse(make_jpeg(shape=(64, 80), quality=90, seed=7))
    geom, coeffs, quant = pipeline.build_plan(img)
    rng = np.random.default_rng(1)
    dc = rng.integers(-1024, 1024, coeffs.shape[0]).astype(np.int32)
    garbled = coeffs.copy()
    garbled[:, 0] = rng.integers(-2048, 2047, coeffs.shape[0])
    got = pipeline._decode_rgb_planar_fused(
        geom, jnp.asarray(garbled), jnp.asarray(quant), jnp.asarray(dc)
    )
    direct = coeffs.copy()
    direct[:, 0] = dc
    want = pipeline._decode_rgb_planar_fused(
        geom, jnp.asarray(direct), jnp.asarray(quant)
    )
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_pixels_extreme_coefficients():
    # large DC of both signs plus two large AC terms per block, with
    # dequantized magnitudes up to ~1000.  Past ~2000 the device's int32
    # IDCT arithmetic (the C reference's width) wraps where the oracle's
    # int64 does not, so the two disagree there (PERF.md, open questions)
    img = parse(make_jpeg(shape=(40, 48), quality=90, seed=5))
    geom, coeffs, quant = pipeline.build_plan(img)
    rng = np.random.default_rng(2)
    n = coeffs.shape[0]
    coeffs = np.zeros(coeffs.shape, np.int16)
    coeffs[:, 0] = rng.choice([-300, -200, 200, 300], n)
    for _ in range(2):
        coeffs[np.arange(n), rng.integers(1, 64, n)] = (
            rng.choice([-40, 40], n)
        )
    out = pipeline._decode_rgb_planar_fused(
        geom, jnp.asarray(coeffs), jnp.asarray(quant)
    )
    _assert_exact_outside_risk(geom, out, _oracle_pixels(img, coeffs))


def test_pixels_end_to_end_oracle():
    # full decode with strict repair stays bit-exact vs the oracle
    data = make_jpeg(shape=(120, 136), quality=92, seed=9)
    got = pipeline.decode(parse(data))
    np.testing.assert_array_equal(np.asarray(got), oracle.decode(parse(data)))


def test_pixels_under_vmap():
    # the fused chunk program calls the pixel path under jax.vmap: the
    # batched program must produce the same pixels as per-image calls
    img = parse(make_jpeg(shape=(48, 64), quality=88, seed=13))
    geom, coeffs, quant = pipeline.build_plan(img)
    rng = np.random.default_rng(3)
    batch = np.stack([coeffs, np.clip(coeffs + rng.integers(
        -2, 3, coeffs.shape), -1023, 1023).astype(coeffs.dtype)])
    quants = np.stack([quant, quant])
    fn = lambda c, q: pipeline._decode_rgb_planar_fused(geom, c, q)
    rgb_v, risk_v = jax.vmap(fn)(jnp.asarray(batch), jnp.asarray(quants))
    for i in range(2):
        rgb_1, risk_1 = fn(jnp.asarray(batch[i]), jnp.asarray(quants[i]))
        np.testing.assert_array_equal(np.asarray(rgb_v[i]), np.asarray(rgb_1))
        np.testing.assert_array_equal(np.asarray(risk_v[i]), np.asarray(risk_1))


def test_pixels_block_domain_equals_plane_path():
    # colour before the block->raster reorder (the fast path) and after
    # it (decode_subsampled_planes + planes_to_rgb) agree bit for bit,
    # risk bits included
    img = parse(make_jpeg(shape=(72, 88), quality=80, seed=21))
    geom, coeffs, quant = pipeline.build_plan(img)
    c, q = jnp.asarray(coeffs), jnp.asarray(quant)
    fast = pipeline._decode_rgb_planar_fused(geom, c, q)
    planes = pipeline.decode_subsampled_planes(geom, c, q)
    slow = pipeline.planes_to_rgb(geom, planes)
    np.testing.assert_array_equal(np.asarray(fast[0]), np.asarray(slow[0]))
    np.testing.assert_array_equal(np.asarray(fast[1]), np.asarray(slow[1]))
