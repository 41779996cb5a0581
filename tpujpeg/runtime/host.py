"""Host entropy-decode runtime dispatch.

Selects the fastest available host-side Huffman decoder:
  1. the native C++ runtime (tpujpeg/runtime/native/, loaded via ctypes), or
  2. the NumPy oracle decoder as fallback.

This mirrors the reference's cudaH split (CPU Huffman feeding device
kernels, legacy_versions/cudaH-implementation/src/parser.cu:281-311), which
was its fastest per-image configuration by ~40x over GPU-serial Huffman
(BASELINE.md).  The device-side alternative is ops/fsm.py; the batch
engine (runtime/batch.py) picks between them per deployment.
"""

from __future__ import annotations

import numpy as np

from ..io.parser import JpegImage
from ..oracle import decoder as oracle

_native = None
_native_checked = False


def _load_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from .native import lib as native_lib

            _native = native_lib.load()
        except Exception:
            _native = None
    return _native


def entropy_decode(img: JpegImage, threads: int = 0) -> np.ndarray:
    """Huffman-decode the scan -> int32 [n_blocks, 64] zigzag coefficients.

    threads caps the native decoder's OpenMP team (0 = all cores); batch
    drivers decoding many images on a pool pass 1."""
    native = _load_native()
    if native is not None:
        return native.entropy_decode(img, threads=threads)
    return oracle.entropy_decode(img)


def backend_name() -> str:
    return "native-cpp" if _load_native() is not None else "numpy-oracle"


def decode_cpu(
    img: JpegImage, fancy: bool = False, threads: int = 0
) -> np.ndarray:
    """Full CPU decode: native entropy + native pixel stage (OpenMP).

    The complete-on-host path — the analog of the reference's
    cpp-decoder (cpp-decoder/src/decoder.cpp) with OpenMP parallelism —
    bit-identical to the oracle on every stream (tests/test_native.py).
    No device, no XLA: the right decoder when no accelerator is attached (the
    prior fallback ran the XLA pixel program on CPU and lost ~4x to
    PIL on the same cores).  Returns uint8 [height, width, 3] RGB.
    """
    native = _load_native()
    if native is None:
        return oracle.decode(img, fancy=fancy).astype(np.uint8)
    from .native.lib import Int16RangeError

    n_blocks = img.n_mcus * img.blocks_per_mcu
    try:
        coeffs = np.empty((n_blocks, 64), np.int16)
        native.entropy_decode(img, out=coeffs, threads=threads)
    except Int16RangeError:
        # corrupt-but-decodable DC walk outside int16: int32 redo keeps
        # "same garbage bit-for-bit" parity with the oracle
        coeffs = native.entropy_decode(img, threads=threads)
    return native.pixels(img, coeffs, fancy=fancy, threads=threads)
