"""Batch engine: bit-exactness across backends, bucketing, stats."""

import numpy as np
import pytest

from tpujpeg.oracle import decoder as oracle
from tpujpeg.io.parser import parse
from tpujpeg.runtime.batch import BatchDecoder

from conftest import make_jpeg, make_jpeg_rst


@pytest.fixture(scope="module")
def batch_data():
    return (
        [make_jpeg(shape=(48, 64), quality=q, seed=q) for q in (60, 80, 95)]
        + [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=9)]
        + [make_jpeg(shape=(32, 40), quality=85, seed=5)]  # second bucket
    )


def expected(datas):
    return [oracle.decode(parse(d)).astype(np.uint8) for d in datas]


@pytest.mark.parametrize("backend", ["host", "auto"])
def test_batch_bit_exact(batch_data, backend):
    dec = BatchDecoder(backend=backend, chunk_size=4)
    got = dec.decode(batch_data)
    for g, e in zip(got, expected(batch_data)):
        np.testing.assert_array_equal(g, e)
    assert dec.stats.n_images == len(batch_data)
    assert dec.stats.chunks >= 2  # two geometry buckets
    assert dec.stats.total_s > 0


def test_batch_fsm_backend():
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in (1, 2)]
    dec = BatchDecoder(backend="fsm", chunk_size=2)
    got = dec.decode(datas)
    for g, e in zip(got, expected(datas)):
        np.testing.assert_array_equal(g, e)
    assert dec.stats.backend == "fsm"


def test_batch_fsm_backend_no_restart_small_single_lane():
    # Small streams without restart markers fit one FSM lane (the implicit
    # whole-image segment) and stay on the plain device FSM path.
    datas = [make_jpeg(shape=(48, 64), quality=q, seed=q) for q in (70, 92)]
    assert all(parse(d).restart_interval == 0 for d in datas)
    dec = BatchDecoder(backend="fsm", chunk_size=2)
    got = dec.decode(datas)
    for g, e in zip(got, expected(datas)):
        np.testing.assert_array_equal(g, e)
    assert dec.stats.backend == "fsm"


@pytest.mark.slow
def test_batch_fsm_backend_large_no_restart_uses_speculative():
    # A no-restart stream past MAX_BLOCKS_PER_LANE (the 800x600 fixture
    # class the reference ships) must decode ON DEVICE under backend='fsm'
    # via the speculative equal-split path (the reference's centerpiece,
    # parser.cu:50-208) — this is a production
    # path, not test-only code.
    import os

    from tpujpeg.ops import fsm
    from conftest import FIXTURES

    with open(os.path.join(FIXTURES, "4_800x600.jpg"), "rb") as f:
        data = f.read()
    img = parse(data)
    assert img.restart_interval == 0
    assert img.n_mcus * img.blocks_per_mcu > fsm.MAX_BLOCKS_PER_LANE
    dec = BatchDecoder(backend="fsm", chunk_size=1)
    got = dec.decode([data])
    np.testing.assert_array_equal(got[0], expected([data])[0])
    # primary: single-pass sync-log path; Jacobi only on a resolve miss
    assert dec.stats.backend in ("fsm-spec-sync", "fsm-spec")
    assert dec.stats.backend == "fsm-spec-sync" or dec.stats.spec_sync_misses


def test_batch_no_fetch(batch_data):
    dec = BatchDecoder(backend="host", chunk_size=8)
    assert dec.decode(batch_data, fetch=False) is None
    assert dec.stats.pixels == sum(
        parse(d).width * parse(d).height for d in batch_data
    )


def test_batch_error_isolation(batch_data):
    datas = list(batch_data)
    datas.insert(2, b"\xff\xd8not a jpeg")
    dec = BatchDecoder(backend="host", chunk_size=4)
    got = dec.decode(datas, on_error="skip")
    assert got[2] is None
    assert 2 in dec.stats.failures
    exp = expected(batch_data)
    others = [g for i, g in enumerate(got) if i != 2]
    for g, e in zip(others, exp):
        np.testing.assert_array_equal(g, e)


def test_distributed_shard_list():
    from tpujpeg.parallel import distributed as dist

    items = list(range(10))
    shards = [dist.shard_list(items, index=i, count=3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert max(len(s) for s in shards) - min(len(s) for s in shards) <= 1
    assert dist.allreduce_metrics({"x": 2.0}) == {"x": 2.0}


def test_batch_gather_backend():
    # the lockstep gather decoder stays wired as a selectable backend
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in (5, 6)]
    dec = BatchDecoder(backend="gather", chunk_size=2)
    got = dec.decode(datas)
    for g, e in zip(got, expected(datas)):
        np.testing.assert_array_equal(g, e)
    assert dec.stats.backend == "gather"


def test_batch_fsm_malformed_falls_back_to_host_and_counts():
    # Corrupt a stream's tail to 0xFF bytes: segment offsets stay valid,
    # so the chunk dispatches on the device FSM, the all-ones peek lands
    # in the reserved invalid-code region (T.81 C.2) and latches
    # err_malformed, and the engine redoes the chunk on the host — which
    # records a precise per-image failure in skip mode.  The fallback is
    # counted in stats.
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21, quality=95))
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    dec = BatchDecoder(backend="fsm", chunk_size=1, strict=False)
    got = dec.decode_parsed([img], on_error="skip")
    assert dec.stats.fsm_malformed_fallbacks >= 1, dec.stats.as_dict()
    assert got[0] is None
    assert 0 in dec.stats.failures


def test_batch_fsm_k_retry(monkeypatch):
    # Force the fast symbol-step count below what noisy content needs:
    # the engine must retry the chunk ON DEVICE at STEPS_SAFE (counted in
    # stats), not fall back to the host, and stay bit-exact.
    from tpujpeg.ops import fsm

    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in (1, 2)]
    monkeypatch.setattr(fsm, "STEPS_PRODUCTION", 1)
    dec = BatchDecoder(backend="fsm", chunk_size=2)
    got = dec.decode(datas)
    for g, e in zip(got, expected(datas)):
        np.testing.assert_array_equal(g, e)
    assert dec.stats.fsm_k_retries == 1
    assert dec.stats.fsm_envelope_fallbacks == 0


def test_batch_cpu_backend_matches_oracle():
    # complete native decode, no device/XLA touched (mesh is None)
    datas = [
        make_jpeg(shape=(64, 80), seed=1),
        make_jpeg(shape=(40, 56), seed=2, subsampling=2),  # mixed geometry
        make_jpeg(shape=(48, 48), seed=3, gray=True),
    ]
    dec = BatchDecoder(backend="cpu", chunk_size=2)
    assert dec.mesh is None
    out = dec.decode(datas)
    assert dec.stats.backend == "cpu"
    for g, d in zip(out, datas):
        ref = oracle.decode(parse(d))
        np.testing.assert_array_equal(g, ref.astype(np.uint8))


def test_batch_cpu_backend_skip_mode():
    datas = [
        make_jpeg(shape=(64, 80), seed=1),
        make_jpeg(shape=(64, 80), seed=2)[:150],  # truncated
    ]
    dec = BatchDecoder(backend="cpu", chunk_size=4)
    out = dec.decode(datas, on_error="skip")
    assert out[1] is None and 1 in dec.stats.failures
    np.testing.assert_array_equal(
        out[0], oracle.decode(parse(datas[0])).astype(np.uint8)
    )
