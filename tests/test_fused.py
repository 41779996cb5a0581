"""Fused single-program chunk decode (runtime/fused.py).

The fused program must be bit-identical to the staged chain
(fsm.decode_plan + assemble_batched + pixel program) and to the oracle,
including the raw-DC + side-channel coefficient outputs that feed strict
repair, and must be what BatchDecoder uses on a 1-device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpujpeg.io.parser import parse
from tpujpeg.ops import fsm
from tpujpeg.oracle import decoder as oracle
from tpujpeg.parallel import sharding
from tpujpeg.pipeline import Geometry
from tpujpeg.runtime import fused
from tpujpeg.runtime.batch import BatchDecoder

from conftest import make_jpeg_rst


@pytest.fixture(scope="module")
def rst_imgs():
    datas = [
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in range(4)
    ]
    return [parse(d) for d in datas]


def test_fused_matches_oracle_and_staged(rst_imgs):
    imgs = rst_imgs
    plan = fsm.build_plan(imgs, split=False)
    geom = Geometry.of(imgs[0])
    quant = np.stack(
        [
            np.stack([im.quant_tables[c.quant_id] for c in im.components])
            for im in imgs
        ]
    ).astype(np.int32)
    B = len(imgs)
    rgb, risk, coeffs, dc, err_mal, err_env, _ = fused.decode_chunk_fused(
        plan, jnp.asarray(quant), geom, B
    )
    assert not bool(jnp.any(err_mal)) and not bool(jnp.any(err_env))

    # pixels == staged chain (decode_plan + assemble + pixel program)
    per_lane, _errs = fsm.decode_plan(plan)
    cf = fsm.assemble_batched(per_lane, layout=plan.layout, pad_to=B)
    mesh = sharding.make_mesh(n_batch=1, n_stripe=1)
    pix = sharding.compiled_batch_decoder(geom, mesh)
    rgb_ref, risk_ref, _m = pix(
        cf.reshape(B, geom.n_blocks, 64), jnp.asarray(quant)
    )
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(rgb_ref))
    np.testing.assert_array_equal(np.asarray(risk), np.asarray(risk_ref))

    # coefficient side channel (raw DC + resolved plane) == oracle entropy
    ent = oracle.entropy_decode(imgs[0])
    c0 = np.asarray(coeffs[0]).astype(np.int32)
    c0[:, 0] = np.asarray(dc[0])
    np.testing.assert_array_equal(c0, ent)


def test_fused_want_coeffs_false(rst_imgs):
    imgs = rst_imgs[:2]
    plan = fsm.build_plan(imgs, split=False)
    geom = Geometry.of(imgs[0])
    quant = np.stack(
        [
            np.stack([im.quant_tables[c.quant_id] for c in im.components])
            for im in imgs
        ]
    ).astype(np.int32)
    rgb, risk, coeffs, dc, *_ = fused.decode_chunk_fused(
        plan, jnp.asarray(quant), geom, len(imgs), want_coeffs=False
    )
    assert coeffs is None and dc is None
    assert rgb.shape[0] == len(imgs)


def test_batch_engine_uses_fused_on_single_device_mesh():
    datas = [
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in (7, 8)
    ]
    mesh = sharding.make_mesh(n_batch=1, n_stripe=1)
    assert mesh.devices.size == 1
    dec = BatchDecoder(backend="fsm", chunk_size=2, mesh=mesh)
    got = dec.decode(datas)
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(
            g, oracle.decode(parse(d)).astype(np.uint8)
        )
    assert dec.stats.backend == "fsm"
