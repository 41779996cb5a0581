"""Column-synchronous FSM entropy decoder == oracle, bit for bit."""

import numpy as np
import pytest

from tpujpeg.errors import JpegError
from tpujpeg.io.parser import parse, parse_file
from tpujpeg.ops import fsm
from tpujpeg.oracle import decoder as oracle

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst


def oracle_batch(imgs):
    return np.concatenate([oracle.entropy_decode(im) for im in imgs])


@pytest.mark.parametrize("rst", [1, 3, 5])
def test_fsm_matches_oracle_restart(rst):
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=rst, seed=rst))
    assert img.n_segments() > 1
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_matches_oracle_single_segment():
    img = parse(make_jpeg(shape=(40, 56), quality=85, seed=2))
    assert img.n_segments() == 1
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_matches_oracle_batch():
    imgs = [
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=7)),
        parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=8)),
    ]
    np.testing.assert_array_equal(fsm.entropy_decode_fsm(imgs), oracle_batch(imgs))


@pytest.mark.parametrize("quality", [30, 75, 97])
def test_fsm_matches_oracle_quality_sweep(quality):
    # quality changes code-length distributions and raw-bit density
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=3, seed=4, quality=quality))
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_matches_oracle_noise():
    # pure noise maximizes symbol density and AC code variety
    import cv2

    rng = np.random.default_rng(11)
    arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(
        ".jpg", arr,
        [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    )
    img = parse(enc.tobytes())
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_envelope_rejects_huge_single_segment():
    # A no-restart stream puts the whole image in one lane; past the
    # packed-event block budget the plan must say so (callers then fall
    # back to the host/speculative decoders).  NB: round-1 used a golden
    # fixture here, but none of them actually exceeds the cap — build a
    # synthetic that does.
    img = parse(make_jpeg(shape=(376, 760), quality=40, seed=0))
    assert img.restart_interval == 0
    assert img.n_mcus * img.blocks_per_mcu > fsm.MAX_BLOCKS_PER_LANE
    with pytest.raises(JpegError):
        fsm.build_plan([img])


@pytest.mark.parametrize("subsampling", [1, 2])
def test_fsm_matches_oracle_subsampled(subsampling):
    img = parse(make_jpeg(shape=(48, 64), subsampling=subsampling, seed=4))
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_matches_oracle_grayscale():
    img = parse(make_jpeg(shape=(40, 48), gray=True, seed=5))
    np.testing.assert_array_equal(
        fsm.entropy_decode_fsm([img]), oracle.entropy_decode(img)
    )


def test_fsm_flags_truncation():
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=11))
    img.scan_data = img.scan_data[: img.scan_data.size // 4].copy()
    img.segment_offsets = img.segment_offsets[
        img.segment_offsets < img.scan_data.size
    ]
    with pytest.raises(JpegError):
        fsm.entropy_decode_fsm([img])


def test_fsm_piecewise_tables_cover_annex_k():
    # The piecewise-affine symbol map must stay within the select-tree cap
    # for libjpeg's default (Annex K) tables.
    img = parse(make_jpeg(shape=(32, 32), seed=0))
    tables = fsm.build_tables(img)
    assert 0 < len(tables.piece_keys) <= fsm.MAX_PIECES
    # spot-check: every (table, code) decodes to the right (length, symbol)
    # through the left-aligned piece map, for every possible bit padding
    import bisect

    for header, table in img.huffman.items():
        tbl_id = (header >> 4) * 2 + (header & 0x0F)
        code = 0
        k = 0
        for length in range(1, 17):
            n = int(table.counts[length - 1])
            for i in range(n):
                for pad in (0, (1 << (16 - length)) - 1):  # 0s and 1s
                    peek = ((code + i) << (16 - length)) | pad
                    key = (tbl_id << 16) | peek
                    j = bisect.bisect_right(tables.piece_keys, key) - 1
                    packed = tables.piece_vals[j]
                    got_len = packed >> 17
                    base = (packed & 0x1FFFF) - 0x10000
                    assert got_len == length, (header, length, i, pad)
                    sym = base + (peek >> (16 - got_len))
                    assert sym == int(table.symbols[k + i]), (header, length, i)
            k += n
            code = (code + n) << 1


def test_fsm_invalid_peek_maps_to_invalid_piece():
    # Peeks above the last canonical code (the T.81 reserved all-ones
    # region) must land on an INVALID_LEN piece, never a valid code.
    import bisect

    img = parse(make_jpeg(shape=(32, 32), seed=0))
    tables = fsm.build_tables(img)
    for header, table in img.huffman.items():
        tbl_id = (header >> 4) * 2 + (header & 0x0F)
        cover_end = 0
        code = 0
        for length in range(1, 17):
            n = int(table.counts[length - 1])
            code += n
            if n:
                cover_end = code << (16 - length)
            code <<= 1
        if cover_end >= 1 << 16:
            continue  # complete table: no invalid region
        for peek in (cover_end, 0xFFFF):
            key = (tbl_id << 16) | peek
            j = bisect.bisect_right(tables.piece_keys, key) - 1
            assert (tables.piece_vals[j] >> 17) == fsm.INVALID_LEN


def test_fsm_grouped_stride_packing():
    # Mixed segment lengths split lanes into two stride classes (upload/
    # scan padding diet); results must stay bit-exact and in lane order.
    import cv2

    def enc(arr):
        ok, e = cv2.imencode(
            ".jpg", arr,
            [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
        )
        assert ok
        return e.tobytes()

    rng = np.random.default_rng(3)
    noisy = [
        parse(enc(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)))
        for _ in range(3)
    ]
    flat = [
        parse(enc(np.full((48, 64, 3), 128 + i, dtype=np.uint8)))
        for i in range(3)
    ]
    imgs = noisy + flat  # 6 x 48 = 288 segments, two length classes
    plan = fsm.build_plan(imgs)
    assert len(plan.groups) == 2, [g[0].shape for g in plan.groups]
    assert plan.groups[0][0].shape[1] > plan.groups[1][0].shape[1]  # strides
    np.testing.assert_array_equal(fsm.entropy_decode_fsm(imgs), oracle_batch(imgs))

    # split=False packs ONE group at the top stride (minimum device scan
    # dispatches, for device-resident/fast-link callers) — same bits out
    plan1 = fsm.build_plan(imgs, split=False)
    assert len(plan1.groups) == 1, [g[0].shape for g in plan1.groups]
    per_lane, (mal, env) = fsm.decode_plan(plan1)
    if np.asarray(env).any():
        # dense lanes outside the fast production envelope: callers retry
        # at STEPS_SAFE (the engine does this on device; mirror it here)
        per_lane, (mal, env) = fsm.decode_plan(plan1, steps=fsm.STEPS_SAFE)
    assert not (np.asarray(mal).any() or np.asarray(env).any())
    got = fsm.assemble(np.asarray(per_lane), plan1.layout)
    np.testing.assert_array_equal(got, oracle_batch(imgs))


@pytest.mark.parametrize("symmap", [True, False])
def test_symmap_matches_piece_tree(monkeypatch, symmap):
    # the two-level symbol map (the default) and the legacy flat piece
    # tree (TPUJPEG_SYMMAP=0) must both decode bit-identically to the
    # oracle — keep BOTH paths covered regardless of the env default
    monkeypatch.setattr(fsm, "_SYMMAP", symmap)
    monkeypatch.setattr(fsm, "_tables_cache", {})
    img = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=11))
    t = fsm.build_tables(img)
    if symmap:
        assert t.len_keys is not None and len(t.len_keys) < len(t.piece_keys)
    else:
        assert t.len_keys is None
    got = fsm.entropy_decode_fsm([img])
    from tpujpeg.oracle import decoder as oracle

    np.testing.assert_array_equal(got, oracle.entropy_decode(img))


def test_symmap_bf16_product_exact():
    # the two-level map reads each symbol through a bf16 one-hot product
    # (oh_hi @ grid, ops/fsm.py): every byte value 0..255 must come back
    # exactly, at every grid position, for grids as tall as table sets need
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for H in (16, 17, 40):
        g = np.arange(H * 16)
        vals = rng.permutation(np.resize(np.arange(256), H * 16))
        grid = vals.reshape(H, 16)
        oh_hi = (g[:, None] >> 4) == np.arange(H)[None, :]
        row = jnp.asarray(oh_hi, jnp.bfloat16) @ jnp.asarray(grid, jnp.bfloat16)
        got = np.asarray(row.astype(jnp.float32))[g, g & 15]
        np.testing.assert_array_equal(got.astype(np.int64), vals)
        assert set(vals.tolist()) == set(range(256))
