"""Fancy (triangle) chroma upsampling: formula, exactness, halo sharding.

The reference is 4:4:4-only; fancy upsampling extends beyond it (SURVEY §8
hard-part #5, PARITY.md designed-for gap).  Contract:
  - ops/upsample.py implements libjpeg jdsample.c h2v1/h2v2 semantics
    exactly (checked against a literal scalar transcription here);
  - the device pipeline with fancy=True equals the NumPy fancy oracle
    bit-for-bit (after the strict color repair);
  - fancy lands strictly closer to PIL/libjpeg than box on subsampled
    content, within a small documented tolerance;
  - the stripe-sharded decoder's halo exchange reproduces the unsharded
    fancy result bit-for-bit.
"""

import numpy as np
import pytest

from tpujpeg.io.parser import parse
from tpujpeg.ops import upsample
from tpujpeg.oracle import decoder as oracle

from conftest import make_jpeg


# -- literal libjpeg jdsample.c transcriptions (scalar, for cross-check) ----


def _h2v1_ref(row):
    n = len(row)
    out = []
    for i in range(n):
        left = row[max(i - 1, 0)]
        right = row[min(i + 1, n - 1)]
        out.append((3 * row[i] + left + 1) >> 2)
        out.append((3 * row[i] + right + 2) >> 2)
    return out


def _h2v2_ref(plane):
    h, w = plane.shape
    out = np.zeros((2 * h, 2 * w), np.int64)
    for r in range(h):
        for near, oy in ((max(r - 1, 0), 0), (min(r + 1, h - 1), 1)):
            colsum = 3 * plane[r].astype(np.int64) + plane[near]
            for c in range(w):
                left = colsum[max(c - 1, 0)]
                right = colsum[min(c + 1, w - 1)]
                out[2 * r + oy, 2 * c] = (3 * colsum[c] + left + 8) >> 4
                out[2 * r + oy, 2 * c + 1] = (3 * colsum[c] + right + 7) >> 4
    return out


def test_h2v1_matches_libjpeg_formula():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 256, (5, 13), np.int64)
    got = upsample.fancy_upsample(s, 2, 1, xp=np)
    want = np.stack([_h2v1_ref(row) for row in s])
    np.testing.assert_array_equal(got, want)


def test_h2v2_matches_libjpeg_formula():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 256, (6, 9), np.int64)
    got = upsample.fancy_upsample(s, 2, 2, xp=np)
    np.testing.assert_array_equal(got, _h2v2_ref(s))


def test_h1v2_is_h2v1_transposed():
    rng = np.random.default_rng(2)
    s = rng.integers(0, 256, (7, 4), np.int64)
    got = upsample.fancy_upsample(s, 1, 2, xp=np)
    want = upsample.fancy_upsample(s.T, 2, 1, xp=np).T
    np.testing.assert_array_equal(got, want)


def test_edges_replicate_exactly():
    # at plane edges the triangle degenerates to an exact copy (libjpeg)
    s = np.arange(64, dtype=np.int64).reshape(8, 8) * 3
    up = upsample.fancy_upsample(s, 2, 1, xp=np)
    np.testing.assert_array_equal(up[:, 0], s[:, 0])
    np.testing.assert_array_equal(up[:, -1], s[:, -1])


def test_device_matches_numpy_definition():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    s = rng.integers(0, 256, (16, 24), np.int32)
    for fh, fv in ((2, 2), (2, 1), (1, 2)):
        got = np.asarray(upsample.fancy_upsample(jnp.asarray(s), fh, fv))
        want = upsample.fancy_upsample(s.astype(np.int64), fh, fv, xp=np)
        np.testing.assert_array_equal(got, want, err_msg=f"{fh}x{fv}")


# -- end-to-end --------------------------------------------------------------


@pytest.mark.parametrize("subsampling", [1, 2])  # 4:2:2, 4:2:0
def test_pipeline_fancy_matches_oracle(subsampling):
    from tpujpeg import pipeline

    img = parse(make_jpeg(shape=(40, 56), subsampling=subsampling, seed=7))
    got = pipeline.decode(img, strict=True, fancy=True)
    want = oracle.decode(img, fancy=True)
    np.testing.assert_array_equal(got, want)


def test_fancy_is_closer_to_libjpeg_than_box():
    import io

    from PIL import Image

    # noisy chroma maximizes the box-vs-triangle gap
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=92, subsampling=2)
    data = buf.getvalue()
    img = parse(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
    box = oracle.decode(img, fancy=False).astype(int)
    fancy = oracle.decode(img, fancy=True).astype(int)
    err_box = np.abs(box - pil).max()
    err_fancy = np.abs(fancy - pil).max()
    assert err_fancy < err_box, (err_fancy, err_box)
    # residual differences: libjpeg's jpeg_idct_islow vs the reference's
    # integer IDCT, and edge handling over DCT padding (ops/upsample.py)
    assert err_fancy <= 8, err_fancy


@pytest.mark.parametrize("factor_name", ["411", "440"])
def test_pipeline_fancy_exotic_factors_match_oracle(factor_name):
    """4:1:1 (fh=4: fancy falls back to box, like libjpeg) and 4:4:0
    (fh=1, fv=2: the h1v2 triangle pass).  Guards the _repair routing:
    its box-vs-fancy split must agree with upsample_plane's factor
    gates for every (fh, fv), not just 4:2:0/4:2:2."""
    cv2 = pytest.importorskip("cv2")
    from tpujpeg import pipeline

    rng = np.random.default_rng(13)
    arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)  # noisy: more
    # saturated pixels -> better odds of exercising the risk-repair path
    ok, enc = cv2.imencode(
        ".jpg", arr,
        [cv2.IMWRITE_JPEG_QUALITY, 92,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor_name}")],
    )
    assert ok
    img = parse(enc.tobytes())
    fh = img.max_h // min(c.h for c in img.components)
    fv = img.max_v // min(c.v for c in img.components)
    assert (fh, fv) == {"411": (4, 1), "440": (1, 2)}[factor_name]
    got = pipeline.decode(img, strict=True, fancy=True)
    want = oracle.decode(img, fancy=True)
    np.testing.assert_array_equal(got, want)


def test_batch_fancy():
    from tpujpeg.runtime.batch import BatchDecoder

    datas = [make_jpeg(shape=(40, 56), subsampling=2, seed=s) for s in (1, 2)]
    dec = BatchDecoder(backend="host", chunk_size=2, fancy=True)
    got = dec.decode(datas)
    for g, d in zip(got, datas):
        want = oracle.decode(parse(d), fancy=True)
        np.testing.assert_array_equal(g, want.astype(np.uint8))


def test_striped_fancy_halo_exchange_bit_exact():
    # 4:2:0 image, MCU rows sharded over 4 stripes: the 1-row chroma halo
    # exchange must reproduce the unsharded fancy decode bit-for-bit.
    from tpujpeg.parallel import sharding

    img = parse(make_jpeg(shape=(64, 48), subsampling=2, seed=13))
    assert img.mcus_y % 4 == 0
    got = sharding.decode_striped(img, n_stripes=4, fancy=True)
    want = oracle.decode(img, fancy=True)
    np.testing.assert_array_equal(got, want)


def test_striped_box_still_bit_exact():
    from tpujpeg.parallel import sharding

    img = parse(make_jpeg(shape=(64, 48), subsampling=2, seed=14))
    got = sharding.decode_striped(img, n_stripes=4, fancy=False)
    np.testing.assert_array_equal(got, oracle.decode(img, fancy=False))