"""ctypes bindings for the native host entropy decoder.

The native layer plays the role of the reference's host-side C++ runtime
(Stream/HuffmanTree/extract, cuda-decoder/src/parser.cu:360-471 and the
cudaH host Huffman decode, legacy_versions/cudaH-implementation/src/
parser.cu:281-311).  ctypes releases the GIL for the duration of each call,
so the batch engine gets real multi-core parallelism from a plain Python
thread pool — no marshaling layer needed.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ...errors import JpegError
from ...io.parser import JpegImage
from . import build

# Must cover the worst-case bit-buffer overrun between the decoder's
# per-block truncation checks (~210 bytes; see entropy.cpp).
_SCAN_PAD = 512

class Int16RangeError(JpegError):
    """int16 output cannot represent the stream's DC predictor walk.

    Only reachable on corrupt-but-decodable streams (conformant baseline
    keeps |DC| <= 2047); callers retry on the int32 path so the
    "same garbage, bit-for-bit" robustness contract holds for every
    output dtype (round-1 advisor finding)."""


_ERRORS = {
    -1: "invalid Huffman code in scan",
    -2: "stream ended early: missing restart segment",
    -3: "truncated scan: bit reader ran past end of data",
    -4: "DC predictor exceeds int16 output range (corrupt stream)",
    -5: "empty scan",
    -6: "truncated scan: no terminating marker (EOI missing)",
    -7: "restart segment table overflow",
}

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


class NativeRuntime:
    """Wraps _tpjnative.so. One instance per process; calls are thread-safe
    (the native code is stateless; LUT cache guarded by a lock)."""

    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        dll.tpj_max_threads.restype = ctypes.c_int32
        dll.tpj_max_threads.argtypes = []
        # OpenMP team size of a call with threads=0 (1: serial build)
        self.max_threads = int(dll.tpj_max_threads())
        common = [
            _u8p, ctypes.c_int64,              # scan, scan_len
            _i64p, ctypes.c_int64,             # seg_offsets, n_segments
            ctypes.c_int64, ctypes.c_int64,    # ri, n_mcus
            _i32p, ctypes.c_int64,             # pattern, bpm
            _i32p, _i32p, ctypes.c_int64,      # dc_rows, ac_rows, n_comp
            _u16p, ctypes.c_int32,             # luts, n_threads (0 = all)
        ]
        fn = dll.tpj_entropy_decode
        fn.restype = ctypes.c_int32
        fn.argtypes = common + [_i32p]
        self._decode = fn
        fn16 = dll.tpj_entropy_decode16
        fn16.restype = ctypes.c_int32
        fn16.argtypes = common + [
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        ]
        self._decode16 = fn16
        fnd = dll.tpj_destuff
        fnd.restype = ctypes.c_int32
        fnd.argtypes = [
            _u8p, ctypes.c_int64,              # buf, n
            _u8p, _i64p,                       # out, out_len
            _i64p, ctypes.c_int64, _i64p,      # seg_offsets, cap, n_segs
        ]
        self._destuff = fnd
        pix_common = [
            _i32p,                              # quant [n_comp, 64]
            _i32p, _i32p, _i32p,                # comp h / v / quant slot
            ctypes.c_int64, ctypes.c_int64,     # n_comp, mcus_x
            ctypes.c_int64, ctypes.c_int64,     # mcus_y, width
            ctypes.c_int64, ctypes.c_int32,     # height, fancy
            ctypes.c_int32,                     # n_threads (0 = all cores)
            _u8p,                               # out rgb [H, W, 3]
        ]
        fnp32 = dll.tpj_pixels32
        fnp32.restype = ctypes.c_int32
        fnp32.argtypes = [_i32p] + pix_common
        self._pixels32 = fnp32
        fnp16 = dll.tpj_pixels16
        fnp16.restype = ctypes.c_int32
        fnp16.argtypes = [
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        ] + pix_common
        self._pixels16 = fnp16
        self._lut_cache: dict[bytes, np.ndarray] = {}
        self._lut_lock = threading.Lock()

    # -- de-stuffing ---------------------------------------------------------

    def destuff(self, sub: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """De-stuff an entropy-coded scan (bytes past the SOS header).

        Byte-for-byte identical to io.destuff.destuff_scan's NumPy path
        (enforced by tests/test_native.py); the serial C++ walk replaces
        three NumPy passes (classify / cumsum / gather) per image, which
        dominated host parse at batch scale.
        """
        sub = np.ascontiguousarray(sub, dtype=np.uint8)
        out = np.empty(sub.size, np.uint8)
        # worst case: a restart pair every 2 bytes
        segs = np.empty(sub.size // 2 + 2, np.int64)
        out_len = np.zeros(1, np.int64)
        n_segs = np.zeros(1, np.int64)
        rc = self._destuff(sub, sub.size, out, out_len, segs, segs.size, n_segs)
        if rc != 0:
            raise JpegError(_ERRORS.get(rc, f"native destuff failed ({rc})"))
        return (
            np.ascontiguousarray(out[: int(out_len[0])]),
            segs[: int(n_segs[0])].copy(),
        )

    # -- LUTs ---------------------------------------------------------------

    def _lut_for(self, table) -> np.ndarray:
        key = table.counts.tobytes() + table.symbols.tobytes()
        with self._lut_lock:
            hit = self._lut_cache.get(key)
        if hit is not None:
            return hit
        sym, length = table.build_lut(16)
        packed = (
            (length.astype(np.uint16) << 8) | sym.astype(np.uint16)
        )
        with self._lut_lock:
            self._lut_cache[key] = packed
        return packed

    def _pack_luts(self, img: JpegImage):
        """Stack the scan's Huffman LUTs into [n_luts, 65536] arrays and map
        each component to its DC/AC row."""
        rows: dict[int, int] = {}
        packed: list[np.ndarray] = []

        def row_of(header: int) -> int:
            if header not in rows:
                table = img.huffman.get(header)
                if table is None:
                    raise JpegError(f"scan references missing DHT table {header:#x}")
                rows[header] = len(packed)
                packed.append(self._lut_for(table))
            return rows[header]

        dc_rows = np.array(
            [row_of(c.dc_table_id) for c in img.components], np.int32
        )
        ac_rows = np.array(
            [row_of(0x10 | c.ac_table_id) for c in img.components], np.int32
        )
        return np.ascontiguousarray(np.concatenate(packed)), dc_rows, ac_rows

    # -- decode -------------------------------------------------------------

    def entropy_decode(
        self, img: JpegImage, out: np.ndarray | None = None,
        threads: int = 0,
    ) -> np.ndarray:
        """Huffman-decode the scan -> [n_blocks, 64] zigzag coefficients.

        Bit-identical to tpujpeg.oracle.decoder.entropy_decode (enforced by
        tests/test_native.py).  `out` may be a preallocated contiguous
        int32 or int16 [n_blocks, 64] array (int16 is safe for conformant
        baseline scans and halves the device upload); default int32.
        threads caps the OpenMP team (0 = all cores): batch drivers
        decoding many images on a pool pass 1 — image-level parallelism
        beats oversubscribed intra-image teams.
        """
        luts, dc_rows, ac_rows = self._pack_luts(img)
        scan = np.empty(img.scan_data.size + _SCAN_PAD, np.uint8)
        scan[: img.scan_data.size] = img.scan_data
        scan[img.scan_data.size :] = 0
        pattern = np.asarray(img.mcu_block_pattern(), np.int32)
        segs = np.ascontiguousarray(img.segment_offsets, dtype=np.int64)
        n_blocks = img.n_mcus * img.blocks_per_mcu
        if out is None:
            out = np.empty((n_blocks, 64), np.int32)
        if out.shape != (n_blocks, 64) or not out.flags.c_contiguous:
            raise ValueError("bad output buffer")
        fn = {np.dtype(np.int32): self._decode, np.dtype(np.int16): self._decode16}[
            out.dtype
        ]
        rc = fn(
            scan, img.scan_data.size,
            segs, segs.size,
            img.restart_interval, img.n_mcus,
            pattern, pattern.size,
            dc_rows, ac_rows, len(img.components),
            luts, threads,
            out.reshape(-1),
        )
        if rc == -4:
            raise Int16RangeError(_ERRORS[-4])
        if rc != 0:
            raise JpegError(_ERRORS.get(rc, f"native decode failed ({rc})"))
        return out

    # -- pixel stage ---------------------------------------------------------

    def pixels(
        self, img: JpegImage, coeffs: np.ndarray, fancy: bool = False,
        threads: int = 0,
    ) -> np.ndarray:
        """Full native pixel stage: dequant + zigzag + IDCT + upsample +
        color (pixels.cpp, OpenMP).  Bit-identical to the oracle's pixel
        stages (enforced by tests/test_native.py); together with
        entropy_decode this is a complete CPU decoder, the analog of the
        reference's cpp-decoder.  coeffs: [n_blocks, 64] int16/int32
        zigzag, DPCM resolved.  Returns uint8 [height, width, 3] RGB."""
        coeffs = np.ascontiguousarray(coeffs)
        quant = np.ascontiguousarray(
            np.stack(
                [img.quant_tables[c.quant_id] for c in img.components]
            ).astype(np.int32)
        )
        comp_h = np.array([c.h for c in img.components], np.int32)
        comp_v = np.array([c.v for c in img.components], np.int32)
        comp_q = np.arange(len(img.components), dtype=np.int32)
        out = np.empty((img.height, img.width, 3), np.uint8)
        fn = {
            np.dtype(np.int32): self._pixels32,
            np.dtype(np.int16): self._pixels16,
        }[coeffs.dtype]
        rc = fn(
            coeffs.reshape(-1), quant, comp_h, comp_v, comp_q,
            len(img.components), img.mcus_x, img.mcus_y,
            img.width, img.height, int(fancy), threads, out,
        )
        if rc != 0:
            raise JpegError(f"native pixel stage failed ({rc})")
        return out


_runtime: NativeRuntime | None = None
_load_lock = threading.Lock()


def load() -> NativeRuntime:
    """Build (if needed) and load the native runtime. Raises on failure."""
    global _runtime
    with _load_lock:
        if _runtime is None:
            path = build.build()
            dll = ctypes.CDLL(str(path))
            if dll.tpj_version() != 8:
                raise RuntimeError("native ABI version mismatch")
            _runtime = NativeRuntime(dll)
    return _runtime
