"""Size-class bucketed decode: recompile-free mixed-size batches.

The reference decodes any image size with one compiled binary (dims are
runtime values, cuda-decoder/src/parser.cu:324-331); the XLA answer is
pad-to-bucket MCU grids (pipeline.bucket_geometry) with true extents as
runtime scalars.  Contract here: a mixed-size manifest decodes bit-exact
vs the oracle while compiling one pixel program PER BUCKET, not per size.
"""

import numpy as np
import pytest

from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.pipeline import Geometry, bucket_geometry, bucket_up
from tpujpeg.runtime.batch import BatchDecoder

from conftest import make_jpeg


def test_bucket_ladder():
    # monotone, >= n, and reused across nearby sizes
    prev = 0
    for n in range(1, 400):
        b = bucket_up(n)
        assert b >= n
        assert b >= prev
        prev = b
    # ladder values are sparse: 1..256 maps to a handful of classes
    classes = {bucket_up(n) for n in range(1, 257)}
    assert len(classes) <= 16


def test_bucket_geometry_shares_classes():
    imgs = [
        parse(make_jpeg(shape=s, seed=i))
        for i, s in enumerate([(64, 80), (60, 88), (50, 80), (64, 82)])
    ]
    buckets = {bucket_geometry(Geometry.of(im)) for im in imgs}
    # 4 distinct exact geometries, one shared bucket class
    assert len({Geometry.of(im) for im in imgs}) == 4
    assert len(buckets) == 1


def _roundtrip(datas, **kw):
    dec = BatchDecoder(size_buckets=True, chunk_size=4, **kw)
    out = dec.decode(datas)
    assert all("bucketed" in b for b in dec.stats.backend.split("+"))
    return out, dec


@pytest.mark.parametrize("backend", ["oracle", "host"])
def test_mixed_sizes_match_oracle(backend):
    shapes = [(64, 80), (60, 88), (57, 41), (120, 56), (48, 64), (64, 80)]
    datas = [
        make_jpeg(shape=s, quality=88, seed=i) for i, s in enumerate(shapes)
    ]
    out, _ = _roundtrip(datas, backend=backend)
    for data, got in zip(datas, out):
        ref = oracle.decode(parse(data))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_subsampled_fancy_matches_exact():
    # 4:2:0 + fancy triangle upsampling: the hard case — bucket padding
    # sits right past the true sample extent, and the filter's bottom/
    # right replication edges must move to the TRUE extent (runtime
    # scalars) to stay bit-identical to the exact-geometry decode.
    shapes = [(40, 56), (56, 40), (34, 50)]
    datas = [
        make_jpeg(shape=s, quality=85, seed=7 + i, subsampling=2)
        for i, s in enumerate(shapes)
    ]
    out, _ = _roundtrip(datas, backend="host", fancy=True)
    for data, got in zip(datas, out):
        ref = oracle.decode(parse(data), fancy=True)
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_grayscale():
    datas = [
        make_jpeg(shape=(40, 56), seed=3, gray=True),
        make_jpeg(shape=(48, 48), seed=4, gray=True),
    ]
    out, _ = _roundtrip(datas, backend="host")
    for data, got in zip(datas, out):
        ref = oracle.decode(parse(data))
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_compile_count_bounded():
    # many distinct sizes, one bucket class -> ONE pixel-program compile
    from tpujpeg.parallel import sharding

    shapes = [(64, 80), (60, 88), (50, 80), (64, 82), (58, 86), (52, 84)]
    datas = [make_jpeg(shape=s, seed=i) for i, s in enumerate(shapes)]
    before = sharding.compiled_batch_decoder.cache_info().currsize
    out, dec = _roundtrip(datas, backend="host")
    after = sharding.compiled_batch_decoder.cache_info().currsize
    assert after - before <= 1  # <= because an earlier test may share it
    assert len(out) == len(datas)


def test_bucketed_skip_mode_isolates_bad_stream():
    datas = [
        make_jpeg(shape=(64, 80), seed=1),
        make_jpeg(shape=(60, 88), seed=2)[:200],  # truncated mid-scan
        make_jpeg(shape=(50, 80), seed=3),
    ]
    dec = BatchDecoder(backend="host", size_buckets=True, chunk_size=4)
    out = dec.decode(datas, on_error="skip")
    assert out[1] is None and 1 in dec.stats.failures
    for i in (0, 2):
        ref = oracle.decode(parse(datas[i]))
        np.testing.assert_array_equal(out[i], ref.astype(np.uint8))


# ---------------------------------------------------------------------------
# FSM-backend buckets (round 4): the fused device bucket program
# ---------------------------------------------------------------------------


def _mesh1():
    from tpujpeg.parallel import sharding

    return sharding.make_mesh(n_batch=1, n_stripe=1)


def _rst_row_aligned(shape, seed, quality=90):
    """4:4:4 restart JPEG with ri == mcus_x (k=1, row-aligned)."""
    from conftest import make_jpeg_rst

    return make_jpeg_rst(
        shape=shape, quality=quality, rst_interval=-(-shape[1] // 8),
        seed=seed,
    )


def test_bucketed_fsm_mixed_sizes_match_oracle():
    shapes = [(64, 80), (60, 88), (57, 41), (120, 56), (48, 64), (64, 80)]
    datas = [_rst_row_aligned(s, seed=i) for i, s in enumerate(shapes)]
    dec = BatchDecoder(
        backend="fsm", size_buckets=True, chunk_size=4, mesh=_mesh1()
    )
    out = dec.decode(datas)
    assert "fsm-bucketed" in dec.stats.backend, dec.stats.backend
    for data, got in zip(datas, out):
        ref = oracle.decode(parse(data))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_fsm_non_aligned_restarts_fall_back():
    # restart interval NOT a multiple of mcus_x: outside the bucket-FSM
    # envelope -> host-bucketed fallback, still exact, no error raised
    from conftest import make_jpeg_rst

    datas = [
        make_jpeg_rst(shape=(64, 80), rst_interval=3, seed=1),
        make_jpeg_rst(shape=(60, 88), rst_interval=3, seed=2),
    ]
    dec = BatchDecoder(
        backend="fsm", size_buckets=True, chunk_size=4, mesh=_mesh1()
    )
    out = dec.decode(datas)
    assert "host-bucketed" in dec.stats.backend
    for data, got in zip(datas, out):
        ref = oracle.decode(parse(data))
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_fsm_compile_count_bounded():
    # many distinct sizes in one bucket class -> ONE fused bucket compile
    from tpujpeg.runtime import fused

    shapes = [(64, 80), (60, 88), (50, 80), (64, 82), (58, 86), (52, 84)]
    datas = [_rst_row_aligned(s, seed=i) for i, s in enumerate(shapes)]
    dec = BatchDecoder(
        backend="fsm", size_buckets=True, chunk_size=6, mesh=_mesh1()
    )
    before = fused.compiled_fused_bucketed.cache_info().currsize
    out = dec.decode(datas)
    after = fused.compiled_fused_bucketed.cache_info().currsize
    assert "fsm-bucketed" in dec.stats.backend
    assert after - before <= 1
    assert all(o is not None for o in out)
    # decode a second, different mix of the same bucket: zero new compiles
    datas2 = [_rst_row_aligned(s, seed=10 + i)
              for i, s in enumerate([(62, 78), (54, 86)])]
    out2 = dec.decode(datas2)
    assert fused.compiled_fused_bucketed.cache_info().currsize == after
    for data, got in zip(datas2, out2):
        ref = oracle.decode(parse(data))
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_bucketed_fsm_mixed_k_splits_chunks():
    # k=1 and k=2 images of one bucket class land in separate chunks and
    # both decode exactly
    from conftest import make_jpeg_rst

    d1 = _rst_row_aligned((64, 80), seed=1)                    # k=1
    d2 = make_jpeg_rst(shape=(60, 88), rst_interval=22, seed=2)  # k=2
    dec = BatchDecoder(
        backend="fsm", size_buckets=True, chunk_size=4, mesh=_mesh1()
    )
    out = dec.decode([d1, d2])
    for data, got in zip([d1, d2], out):
        ref = oracle.decode(parse(data))
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_compile_ladder_bound():
    """The mixed-size jit-key space is enumerable for a
    declared corpus envelope, real plans stay inside it, and partial
    chunks reuse the full chunk's key (pad_imgs lane padding)."""
    from tpujpeg.ops import fsm
    from tpujpeg.runtime import ladder

    # envelope: images <= 2000 px/side, restart segments <= 4 KiB, k=1
    keys = ladder.bucketed_jit_keys(2000, 4096, k_values=(1,))
    grid = ladder.mcu_bucket_ladder(250)
    strides = ladder.stride_ladder(4096)
    assert grid == (4, 6, 8, 11, 15, 20, 26, 34, 45, 59, 77, 101, 132,
                    172, 224, 292)
    # every bucket axis value <= 292, strides pow2 to 1 KiB then 512 steps
    assert strides == (64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072,
                       3584, 4096)
    n_bx = sum(1 for bx in grid if bx * 3 <= 512)   # materialize cap
    assert len(keys) == n_bx * len(grid) * len(strides)
    assert len(keys) <= 2500  # the declared envelope's hard bound

    # real mixed corpora mint keys INSIDE the enumeration, and a partial
    # chunk's plan matches the full chunk's shapes exactly
    shapes = [(64, 80), (120, 104), (56, 200), (88, 88)]
    imgs = [
        parse(_rst_row_aligned(s, seed=i)) for i, s in enumerate(shapes)
    ]
    seen = set()
    for img in imgs:
        bucket = bucket_geometry(Geometry.of(img))
        plan = fsm.build_plan_bucketed([img], bucket, pad_imgs=6)
        k = ladder.observed_key(plan, bucket)
        assert k in set(keys), k
        seen.add(k + (plan.xs.shape[0],))
    # same image padded as a 6-image chunk vs alone-in-a-6-chunk: one key
    img = imgs[0]
    bucket = bucket_geometry(Geometry.of(img))
    p_full = fsm.build_plan_bucketed([img] * 6, bucket, pad_imgs=6)
    p_part = fsm.build_plan_bucketed([img], bucket, pad_imgs=6)
    assert p_full.xs.shape == p_part.xs.shape
    assert ladder.observed_key(p_full, bucket) == ladder.observed_key(
        p_part, bucket
    )
