"""Speculative equal-split FSM decode (no restart markers) == oracle.

All cases share chunk_bytes=256 so the jit cache compiles the speculative
graphs once per table/geometry family (compiles take a while).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # spec graphs are the longest compiles

from tpujpeg.errors import JpegError
from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm
from tpujpeg.oracle import decoder as oracle

from conftest import make_jpeg

CHUNK = 256


def test_spec_matches_oracle():
    img = parse(make_jpeg(shape=(64, 80), quality=88, seed=3))
    assert img.restart_interval == 0
    got = fsm.decode_speculative(img, chunk_bytes=CHUNK)
    np.testing.assert_array_equal(got, oracle.entropy_decode(img))


def test_spec_single_chunk():
    # tiny image -> whole scan in one lane (degenerate split)
    img = parse(make_jpeg(shape=(16, 16), quality=80, seed=1))
    plan = fsm.build_spec_plan(img, CHUNK)
    assert plan.n_lanes == 1
    got = fsm.decode_speculative(img, chunk_bytes=CHUNK)
    np.testing.assert_array_equal(got, oracle.entropy_decode(img))


def test_spec_noise_stream():
    # noise maximizes symbol density; boundary guesses land mid-code often
    img = parse(make_jpeg(shape=(48, 64), quality=92, seed=7, smooth=False))
    got = fsm.decode_speculative(img, chunk_bytes=CHUNK)
    np.testing.assert_array_equal(got, oracle.entropy_decode(img))


def test_spec_truncated_raises():
    img = parse(make_jpeg(shape=(64, 80), quality=88, seed=3))
    img.scan_data = img.scan_data[: img.scan_data.size // 2].copy()
    with pytest.raises(JpegError):
        fsm.decode_speculative(img, chunk_bytes=CHUNK)


def test_spec_batch_matches_oracle():
    # several images, different content/sizes of lanes, one Jacobi fixed
    # point for the whole batch (the production fsm-spec chunk shape)
    imgs = [
        parse(make_jpeg(shape=(64, 80), quality=88, seed=s))
        for s in (3, 4, 5, 6)
    ]
    got = fsm.decode_speculative_batch(imgs, chunk_bytes=CHUNK)
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, oracle.entropy_decode(img))


def test_spec_batch_one_bad_stream_raises():
    imgs = [
        parse(make_jpeg(shape=(64, 80), quality=88, seed=s)) for s in (3, 4)
    ]
    imgs[1].scan_data = imgs[1].scan_data[: imgs[1].scan_data.size // 2].copy()
    with pytest.raises(JpegError):
        fsm.decode_speculative_batch(imgs, chunk_bytes=CHUNK)


def test_spec_batch_device_out_matches_host():
    import jax

    imgs = [
        parse(make_jpeg(shape=(64, 80), quality=88, seed=s)) for s in (3, 4)
    ]
    host = fsm.decode_speculative_batch(imgs, chunk_bytes=CHUNK)
    coeffs, (err_mal, err_env) = fsm.decode_speculative_batch(
        imgs, chunk_bytes=CHUNK, device_out=True, pad_to=3
    )
    assert not bool(jax.device_get((err_mal | err_env).any()))
    dev = np.asarray(jax.device_get(coeffs))
    assert dev.shape[0] == 3
    for bi, h in enumerate(host):
        np.testing.assert_array_equal(dev[bi], h)
    assert not dev[2].any()  # padding rows are zero


def test_spec_envelope_error_and_safe_retry():
    # steps=(1,1) is below any real stream's symbol density: the count
    # pass must latch env lanes and raise the TYPED envelope error (not
    # garbage quotas / "inconsistent block counts"), and the STEPS_SAFE
    # retry must decode bit-exact — the on-device K-retry contract the
    # batch engine's spec path relies on.
    img = parse(make_jpeg(shape=(48, 64), quality=92, seed=7, smooth=False))
    with pytest.raises(fsm.SpecEnvelopeError):
        fsm.decode_speculative_batch([img], chunk_bytes=CHUNK, steps=(1, 1))
    assert fsm.steps_below_safe((1, 1))
    got = fsm.decode_speculative_batch(
        [img], chunk_bytes=CHUNK, steps=fsm.STEPS_SAFE
    )[0]
    np.testing.assert_array_equal(got, oracle.entropy_decode(img))


# ---------------------------------------------------------------------------
# Single-pass sync-log path (round 4): adopt cold events via anchor match
# ---------------------------------------------------------------------------


def _sync_or_skip(imgs, **kw):
    # small test chunks give the cold pass little room to self-sync; a
    # typed miss (-> Jacobi in production) is a legitimate outcome, but
    # anything RETURNED must be bit-exact
    try:
        return fsm.decode_speculative_sync(imgs, **kw)
    except (fsm.SpecSyncMiss, fsm.SpecEnvelopeError) as e:
        pytest.skip(f"sync resolve fell back ({e})")


def test_spec_sync_matches_oracle():
    imgs = [
        parse(make_jpeg(shape=(64, 80), quality=88, seed=s))
        for s in (3, 4, 5, 6)
    ]
    got = _sync_or_skip(imgs, chunk_bytes=CHUNK, device_out=False)
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, oracle.entropy_decode(img))


def test_spec_sync_device_out_matches_oracle():
    import jax

    imgs = [
        parse(
            make_jpeg(
                shape=(64, 80), quality=85 + (s % 3) * 5, seed=s,
                smooth=(s % 2 == 0),
            )
        )
        for s in range(6)
    ]
    coeffs, (err_a, err_b) = _sync_or_skip(
        imgs, chunk_bytes=CHUNK, device_out=True, pad_to=8
    )
    assert not bool(jax.device_get((err_a | err_b).any()))
    dev = np.asarray(jax.device_get(coeffs))
    assert dev.shape[0] == 8
    for bi, img in enumerate(imgs):
        np.testing.assert_array_equal(dev[bi], oracle.entropy_decode(img))
    assert not dev[6:].any()


def test_spec_sync_noise_stream():
    # noise maximizes symbol density AND garbles cold prefixes; the sync
    # resolve must still adopt (self-synchronization) or fall back loudly
    imgs = [
        parse(make_jpeg(shape=(48, 64), quality=92, seed=7, smooth=False))
    ]
    got = _sync_or_skip(imgs, chunk_bytes=CHUNK, device_out=False)
    np.testing.assert_array_equal(
        got[0], oracle.entropy_decode(imgs[0])
    )


def test_spec_sync_420_subsampled():
    # 4:2:0 MCUs have bpm=6, so the block phase needs 3 bits in the
    # packed anchor — the 2-bit packing aliased phases 4-5 into the bit
    # position and could falsely certify an unsynced lane (advisor r4,
    # medium).  Everything returned must be bit-exact.
    imgs = [
        parse(
            make_jpeg(
                shape=(96, 112), quality=88, seed=s, subsampling=2,
            )
        )
        for s in (3, 4, 5)
    ]
    assert imgs[0].blocks_per_mcu == 6
    got = _sync_or_skip(imgs, chunk_bytes=CHUNK, device_out=False)
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, oracle.entropy_decode(img))


def test_spec_sync_rejects_exotic_bpm():
    # > 8 blocks/MCU would overflow the 3-bit anchor phase field: the
    # sync path must raise the TYPED miss (-> Jacobi fallback) instead
    # of packing aliased anchors
    img = parse(make_jpeg(shape=(64, 80), quality=88, seed=3))
    plan = fsm.build_spec_plan_batch([img], CHUNK)
    exotic = type(plan)(**{**plan.__dict__, "bpm": 9})
    with pytest.raises(fsm.SpecSyncMiss):
        fsm.spec_sync_start([img], chunk_bytes=CHUNK, plan=exotic)


def test_spec_sync_truncated_falls_out():
    # a truncated stream must raise (miss or envelope), never return
    # silently wrong coefficients
    img = parse(make_jpeg(shape=(64, 80), quality=88, seed=3))
    img.scan_data = img.scan_data[: img.scan_data.size // 2].copy()
    with pytest.raises(JpegError):
        fsm.decode_speculative_sync([img], chunk_bytes=CHUNK,
                                    device_out=False)


def test_engine_spec_sync_fused_tail_single_device():
    # single-device mesh: the engine routes no-restart chunks through the
    # fused sync tail (assemble+gather+pixels one program, int16 + DC
    # side channel); output must stay bit-exact incl. the repair path
    import os

    from tpujpeg.parallel import sharding
    from tpujpeg.runtime.batch import BatchDecoder
    from conftest import FIXTURES

    path = os.path.join(FIXTURES, "4_800x600.jpg")
    if not os.path.exists(path):
        pytest.skip("fixture missing")
    with open(path, "rb") as f:
        data = f.read()
    dec = BatchDecoder(
        backend="fsm", chunk_size=1,
        mesh=sharding.make_mesh(n_batch=1, n_stripe=1),
    )
    got = dec.decode([data])
    assert dec.stats.backend in ("fsm-spec-sync", "fsm-spec")
    ref = oracle.decode(parse(data))
    np.testing.assert_array_equal(got[0], ref.astype(np.uint8))


def test_spec_sync_miss_fallback_in_engine(monkeypatch):
    # a forced resolve miss must fall back to the Jacobi path inside the
    # engine, count in stats, and stay bit-exact
    import os

    from tpujpeg.runtime.batch import BatchDecoder
    from conftest import FIXTURES

    path = os.path.join(FIXTURES, "4_800x600.jpg")
    if not os.path.exists(path):
        pytest.skip("fixture missing")
    with open(path, "rb") as f:
        data = f.read()

    def miss(*a, **k):
        raise fsm.SpecSyncMiss("forced")

    # the resolve is shared by the fused (1-device) and plain sync
    # paths, so failing it exercises the fallback on any mesh
    monkeypatch.setattr(fsm, "spec_sync_resolve_host", miss)
    dec = BatchDecoder(backend="fsm", chunk_size=1)
    got = dec.decode([data])
    monkeypatch.undo()
    assert dec.stats.backend == "fsm-spec"
    assert dec.stats.spec_sync_misses == 1
    ref = oracle.decode(parse(data))
    np.testing.assert_array_equal(got[0], ref.astype(np.uint8))


def test_spec_batch_device_out_wide():
    # wider-than-toy shape: 8 images, mixed smooth/noise content, padded
    # batch, device-resident output (quota row-gather + device DPCM +
    # device-built gather index) — the production fsm-spec chunk shape
    # scaled to CPU-testable size.
    import jax

    imgs = [
        parse(
            make_jpeg(
                shape=(64, 80), quality=85 + (s % 3) * 5, seed=s,
                smooth=(s % 2 == 0),
            )
        )
        for s in range(8)
    ]
    coeffs, (err_mal, err_env) = fsm.decode_speculative_batch(
        imgs, chunk_bytes=CHUNK, device_out=True, pad_to=10
    )
    assert not bool(jax.device_get((err_mal | err_env).any()))
    dev = np.asarray(jax.device_get(coeffs))
    assert dev.shape[0] == 10
    for bi, img in enumerate(imgs):
        np.testing.assert_array_equal(dev[bi], oracle.entropy_decode(img))
    assert not dev[8:].any()
