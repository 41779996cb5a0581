"""Test configuration.

By default tests run on a virtual 8-device CPU mesh, so multi-device
sharding paths are exercised without a card.  Tests marked `gpu` need a
GPU and skip elsewhere (the `gpu_device` fixture decides); run them on
the card with JAX_PLATFORMS=cuda (README, Testing).
"""

import os

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from tpujpeg.utils.cache import compile_cache_dir

compile_cache_dir()

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# Fixture images that have reference golden outputs (testing/ground_truth/).
GOLDEN = [
    "1_320x240",
    "2_400x400",
    "3_120x120",
    "5_200x200",
    "6_225x168",
    "8_401x363",
]


@pytest.fixture(scope="session")
def fixtures_dir() -> str:
    return FIXTURES


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")
    return jax.devices()[0]


def fixture_path(name: str, ext: str = ".jpg") -> str:
    return os.path.join(FIXTURES, name + ext)


def make_jpeg(
    shape=(64, 80),
    quality=90,
    subsampling=0,
    seed=0,
    smooth=True,
    gray=False,
) -> bytes:
    """Encode a synthetic image with PIL (libjpeg) for property tests."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = shape
    if smooth:
        # Low-frequency content: keeps libjpeg-vs-us rounding differences tiny.
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        base = (
            128
            + 90 * np.sin(xx / 17 + seed)
            + 60 * np.cos(yy / 23 - seed)
        )
        arr = np.stack(
            [base, np.roll(base, 7, axis=0), np.roll(base, 13, axis=1)], axis=-1
        )
        arr = np.clip(arr + rng.normal(0, 4, arr.shape), 0, 255).astype(np.uint8)
    else:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if gray:
        img = Image.fromarray(arr[..., 0], mode="L")
    else:
        img = Image.fromarray(arr)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality, subsampling=subsampling)
    return buf.getvalue()


def make_jpeg_rst(shape=(64, 80), quality=90, rst_interval=2, seed=0) -> bytes:
    """Encode a 4:4:4 JPEG with restart markers via OpenCV."""
    import cv2

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(
        ".jpg",
        arr[:, :, ::-1],
        [
            cv2.IMWRITE_JPEG_QUALITY,
            quality,
            cv2.IMWRITE_JPEG_RST_INTERVAL,
            rst_interval,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
        ],
    )
    assert ok
    return enc.tobytes()
