"""Device-path checks that need a GPU (marker `gpu`; skipped elsewhere).

Run on the card with:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import numpy as np
import pytest

import tpujpeg
from tpujpeg.runtime.batch import BatchDecoder
from tpujpeg.utils import corpus

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,backend", [("rst", "fsm"),
                                          ("norst", "fsm-spec")])
def test_batch_decode_bit_exact_on_gpu(gpu_device, kind, backend):
    datas = corpus.load(kind)
    dec = BatchDecoder(backend="fsm", chunk_size=len(datas), strict=True)
    out = dec.decode(datas)
    for o, d in zip(out, datas):
        np.testing.assert_array_equal(o, tpujpeg.decode(d, backend="cpu"))
    assert all(b.startswith(backend) for b in dec.stats.backend.split("+"))
    assert dec.stats.fsm_envelope_fallbacks == 0
    assert dec.stats.fsm_malformed_fallbacks == 0


def test_single_image_device_decode_on_gpu(gpu_device):
    big = corpus.load("big")[0]
    np.testing.assert_array_equal(
        tpujpeg.decode(big, backend="device"), tpujpeg.decode(big, backend="cpu")
    )


def test_color_proof_on_gpu(gpu_device):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from check_color_device import prove

    r = prove(64, log=lambda m: None)
    assert r["platform"] == "gpu"
    assert r["unflagged_mismatches"] == 0, r["first_unflagged"]
