"""tpujpeg — a baseline-JPEG decode engine in JAX/XLA.

Capability-parity rebuild of debesheedas/GPU-JPEG-Decoder: host-side
parsing + canonical Huffman tables, segment-parallel entropy decode on the
device, and batched XLA programs for dequant + inverse zigzag + integer
IDCT + color conversion, sharded over device meshes with shard_map.
"""

from .errors import JpegError
from .io.parser import JpegImage, parse, parse_file

__version__ = "0.1.0"

# single-image decode backends (see decode)
BACKENDS = ("auto", "device", "cpu", "oracle")

__all__ = [
    "JpegError",
    "JpegImage",
    "parse",
    "parse_file",
    "decode",
    "decode_batch",
    "__version__",
]


def decode(data, backend: str = "auto", fancy: bool = False):
    """Decode a JPEG (path or bytes) to an int32 [H, W, 3] RGB array.

    backend:
      'auto' (default) routes SINGLE-image decodes to the native C++
        decoder when it is available: one image cannot amortize a device
        dispatch, and both paths are bit-exact so the answer is
        identical.  Batch throughput belongs to decode_batch /
        BatchDecoder, which amortizes dispatches across chunks.
      'device' forces the device pipeline (host entropy decode, device
        pixel program).
      'cpu' is the complete native C++ decoder; 'oracle' the NumPy
        reference.

    fancy=True selects libjpeg-style triangle chroma upsampling for
    subsampled (4:2:0/4:2:2/4:4:0) streams; default is box, matching the
    reference's 4:4:4-only contract extended by replication.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}"
        )
    img = parse_file(data) if isinstance(data, str) else parse(data)
    if backend == "auto":
        from .runtime import host

        backend = "cpu" if host._load_native() is not None else "device"
    if backend == "oracle":
        from .oracle import decoder as oracle

        return oracle.decode(img, fancy=fancy)
    if backend == "cpu":
        # complete native C++ decode (entropy + pixels, OpenMP) — no
        # device, no XLA; the analog of the reference's cpp-decoder
        from .runtime import host

        return host.decode_cpu(img, fancy=fancy).astype("int32")
    from . import pipeline

    return pipeline.decode(img, fancy=fancy)


def decode_batch(datas, backend: str = "auto", **kwargs):
    """Decode a batch of JPEG byte strings -> list of uint8 [H, W, 3].

    Thin wrapper over runtime.batch.BatchDecoder (geometry bucketing,
    pipelined host/device stages, host-native or device-FSM entropy).
    """
    from .runtime.batch import BatchDecoder

    return BatchDecoder(backend=backend, **kwargs).decode(list(datas))
