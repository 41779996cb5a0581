"""Device-side lockstep-lane Huffman decode via gathers (superseded).

NOTE: the production device decoder is the gather-free FSM in
ops/fsm.py, chosen where dynamic gathers were slow.  This module is kept
as the alternative (its tests pin down the same bit-exactness contract),
as the simplest reference for the lane/segment plan layout, and as the
starting point for a table-lookup decoder on the GPU (ROADMAP X3/X4).

The reference's headline component is a speculative self-synchronizing
parallel Huffman decoder: split the bitstream into equal segments, decode
each on one CUDA thread, iterate until segment boundary states agree, then
prefix-sum symbol counts and re-decode with writes
(cuda-decoder/src/parser.cu:50-208).  A thread-per-segment scalar loop is
the wrong shape for a vector machine.  The formulation here is
**lockstep vector lanes**:

  lane  = one entropy segment (restart interval, ITU T.81 E.1.2 — each
          starts byte-aligned with DC predictors reset, so segments are
          exactly parallel with no speculation),
  step  = one Huffman symbol decoded per lane per iteration of a
          `lax.while_loop`, all lanes in lockstep.

Per step each lane does two gathers into a shared uint32 window array (bit
peek), one gather into a direct-indexed 16-bit-peek LUT (symbol + code
length in one lookup, replacing the reference's 256-way linear scan,
parser.cu:5-19), and ~40 elementwise int ops (EXTEND, run/length update,
DC DPCM).  Decoded coefficients are emitted as (flat index, value) pairs
into step-major buffers and materialized with a single scatter at the end
— so the serial dependency chain is symbol *depth*, while *width* scales
to every segment of every image in the batch at once.

The segment list for a whole batch is flattened into ONE lane axis: with
B images of S segments each, the decode runs B*S lanes in lockstep, and
wall-clock is set by the deepest segment, not the batch size.  This is
the analog of the reference's `<<<batch, 256>>>` batch kernel
(parser.cu:663-682) — except the parallelism is principled (restart
boundaries) rather than speculative.

All state is int32; bit positions address a shared windows array built
from the concatenated de-stuffed scans of the batch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import JpegError
from ..io.parser import JpegImage

LUT_BITS = 16
LUT_SIZE = 1 << LUT_BITS


# ---------------------------------------------------------------------------
# Host-side plan packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentPlan:
    """Device-ready flattened segment table for a batch of scans.

    Static fields (jit cache key): cap, n_lanes, n_blocks_total, bpm, n_comp.
    """

    scan: np.ndarray            # uint8 [n_bytes] concatenated, padded
    seg_start_bits: np.ndarray  # int32 [L] absolute bit offset of segment
    seg_block_base: np.ndarray  # int32 [L] first global block index
    seg_n_blocks: np.ndarray    # int32 [L] blocks in segment (0 = pad lane)
    rows: np.ndarray            # int32 [L, n_comp, 2] LUT row per (comp, dc/ac)
    luts: np.ndarray            # int32 [n_rows, 65536] packed (len << 8) | sym
    pattern: np.ndarray         # int32 [bpm] component index per block in MCU
    cap: int                    # max decode steps (symbols) per lane
    n_blocks_total: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=64)
def _packed_lut_cached(key: bytes, counts: bytes, symbols: bytes) -> np.ndarray:
    from ..io.huffman import HuffmanTable

    table = HuffmanTable(
        counts=np.frombuffer(counts, np.uint8),
        symbols=np.frombuffer(symbols, np.uint8),
    )
    sym, length = table.build_lut(LUT_BITS)
    return (length.astype(np.int32) << 8) | sym.astype(np.int32)


def build_segment_plan(imgs: list[JpegImage]) -> SegmentPlan:
    """Flatten the restart segments of a batch into one lane axis.

    All images must share an MCU block pattern (the batch engine buckets by
    geometry).  Images without restart markers contribute a single
    whole-scan segment — still correct, just one lane of depth.
    """
    bpm = imgs[0].blocks_per_mcu
    pattern = np.asarray(imgs[0].mcu_block_pattern(), np.int32)
    n_comp = len(imgs[0].components)

    lut_rows: dict[bytes, int] = {}
    luts: list[np.ndarray] = []

    def row_of(table) -> int:
        key = table.counts.tobytes() + table.symbols.tobytes()
        if key not in lut_rows:
            lut_rows[key] = len(luts)
            luts.append(
                _packed_lut_cached(key, table.counts.tobytes(), table.symbols.tobytes())
            )
        return lut_rows[key]

    scans: list[np.ndarray] = []
    starts: list[np.ndarray] = []
    bases: list[np.ndarray] = []
    nblocks: list[np.ndarray] = []
    rows: list[np.ndarray] = []
    cap = 1
    byte_base = 0
    block_base = 0

    for img in imgs:
        if img.blocks_per_mcu != bpm or img.mcu_block_pattern() != list(pattern):
            raise JpegError("segment plan requires a uniform MCU block pattern")
        offs = img.segment_offsets.astype(np.int64)
        n_seg = offs.size
        ri = img.restart_interval or img.n_mcus
        seg_mcus = np.full(n_seg, ri, np.int64)
        seg_mcus[-1] = img.n_mcus - ri * (n_seg - 1)
        if np.any(seg_mcus <= 0):
            raise JpegError("inconsistent restart segmentation")
        seg_blocks = seg_mcus * bpm

        # Bit length of each segment bounds its symbol count (every symbol
        # consumes >= 1 bit); 65 symbols/block (DC + 63 AC + EOB) bounds it
        # structurally.  cap is the max over lanes of the tighter bound.
        seg_end = np.append(offs[1:], img.scan_data.size)
        seg_bits = (seg_end - offs) * 8
        cap = max(cap, int(np.minimum(65 * seg_blocks, seg_bits + 65).max()))

        img_rows = np.empty((n_comp, 2), np.int32)
        for ci, c in enumerate(img.components):
            dc = img.huffman.get(c.dc_table_id)
            ac = img.huffman.get(0x10 | c.ac_table_id)
            if dc is None or ac is None:
                raise JpegError("scan references missing DHT table")
            img_rows[ci, 0] = row_of(dc)
            img_rows[ci, 1] = row_of(ac)

        scans.append(img.scan_data)
        starts.append((byte_base + offs) * 8)
        bases.append(block_base + np.cumsum(np.append(0, seg_blocks[:-1])))
        nblocks.append(seg_blocks)
        rows.append(np.broadcast_to(img_rows, (n_seg, n_comp, 2)))
        byte_base += img.scan_data.size
        block_base += img.n_mcus * bpm

    # Pad lanes and the scan buffer to bucketed sizes so the jit cache
    # settles after a few batches instead of recompiling per batch.
    L = int(sum(s.size for s in starts))
    L_pad = max(8, _round_up(L, 64))
    scan_len = _round_up(byte_base + 8, 1 << 16)
    scan = np.zeros(scan_len, np.uint8)
    scan[:byte_base] = np.concatenate(scans)

    def cat_pad(parts, fill):
        flat = np.concatenate(parts)
        out = np.full((L_pad,) + flat.shape[1:], fill, np.int32)
        out[:L] = flat
        return out

    return SegmentPlan(
        scan=scan,
        seg_start_bits=cat_pad(starts, 0),
        seg_block_base=cat_pad(bases, 0),
        seg_n_blocks=cat_pad(nblocks, 0),  # pad lanes: 0 blocks -> born done
        rows=cat_pad(rows, 0),
        luts=np.stack(luts),
        pattern=pattern,
        cap=_round_up(cap, 256),
        n_blocks_total=block_base,
    )


# ---------------------------------------------------------------------------
# Device decode
# ---------------------------------------------------------------------------


def _build_windows(scan: jnp.ndarray) -> jnp.ndarray:
    """uint8 [n] -> uint32 [n-3] big-endian 4-byte windows (one-time op)."""
    s = scan.astype(jnp.uint32)
    return (s[:-3] << 24) | (s[1:-2] << 16) | (s[2:-1] << 8) | s[3:]


@functools.partial(
    jax.jit, static_argnames=("cap", "n_blocks_total", "unroll")
)
def decode_segments(
    scan: jnp.ndarray,            # uint8 [n_bytes]
    seg_start_bits: jnp.ndarray,  # int32 [L]
    seg_block_base: jnp.ndarray,  # int32 [L]
    seg_n_blocks: jnp.ndarray,    # int32 [L]
    rows: jnp.ndarray,            # int32 [L, n_comp, 2]
    luts: jnp.ndarray,            # int32 [n_rows, 65536]
    pattern: jnp.ndarray,         # int32 [bpm]
    *,
    cap: int,
    n_blocks_total: int,
    unroll: int = 4,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Lockstep-lane Huffman decode of all segments.

    Returns (coeffs int32 [n_blocks_total, 64] in zigzag order with DC DPCM
    resolved, err bool [L] — lanes that hit an invalid code or ran out of
    steps; callers fall back to the host decoder when any(err)).
    """
    L = seg_start_bits.shape[0]
    n_comp = rows.shape[1]
    bpm = pattern.shape[0]
    windows = _build_windows(scan)
    n_words = windows.shape[0]
    luts_flat = luts.reshape(-1)
    rows_flat = rows.reshape(-1)
    lane_row_base = jnp.arange(L, dtype=jnp.int32) * (n_comp * 2)
    sentinel = jnp.int32(n_blocks_total * 64)

    def peek16(p):
        i = jnp.minimum(p >> 3, n_words - 1)
        w = windows[i]
        return (((w << (p & 7).astype(jnp.uint32)) >> 16) & 0xFFFF).astype(
            jnp.int32
        )

    def step_fn(state):
        p, blk, k, dc, done, err = state
        comp = pattern[blk % bpm]
        is_dc = k == 0
        row = rows_flat[lane_row_base + comp * 2 + (1 - is_dc.astype(jnp.int32))]
        code = luts_flat[row * LUT_SIZE + peek16(p)]
        clen = code >> 8
        sym = code & 0xFF
        bad = (clen == 0) & ~done

        p2 = p + clen
        size = jnp.where(is_dc, sym, sym & 0x0F)
        run = jnp.where(is_dc, 0, sym >> 4)
        # EXTEND (reference utils.cu:34-41); size in [0, 16].
        raw = peek16(p2) >> (16 - jnp.maximum(size, 1))
        half = 1 << (jnp.maximum(size, 1) - 1)
        val = jnp.where(
            size == 0, 0, jnp.where(raw >= half, raw, raw - 2 * half + 1)
        )
        p3 = p2 + size

        is_eob = ~is_dc & (sym == 0)
        z = jnp.where(is_dc, 0, k + run)
        live = ~done & ~bad
        writes = live & ~is_eob & (z < 64)

        # DC DPCM is lane-local: restart segments reset predictors.
        dc_inc = (
            jnp.where(is_dc & live, val, 0)[:, None]
            * (comp[:, None] == jnp.arange(n_comp, dtype=jnp.int32)[None, :])
        )
        dc = dc + dc_inc
        dc_here = jnp.take_along_axis(dc, comp[:, None], axis=1)[:, 0]
        emit_val = jnp.where(is_dc, dc_here, val)
        emit_idx = jnp.where(
            writes, (seg_block_base + blk) * 64 + z, sentinel
        )

        k_after = jnp.where(
            is_dc, 1, jnp.where(is_eob | (z >= 64), 64, z + 1)
        )
        block_done = k_after >= 64
        blk_next = blk + block_done.astype(jnp.int32)
        k_next = jnp.where(block_done, 0, k_after)
        done_next = done | bad | (blk_next >= seg_n_blocks)

        new_state = (
            jnp.where(done, p, p3),
            jnp.where(done, blk, blk_next),
            jnp.where(done, k, k_next),
            dc,
            done_next,
            err | bad,
        )
        return new_state, emit_val, emit_idx

    # Emit structure: a naive while_loop carrying [cap, L] emit buffers
    # copies them every iteration (XLA can't alias dynamic-update-slice
    # carries here) — ~80 MB/iter, catastrophically slow.  Instead: an outer
    # scan over chunks of K steps whose ys ARE the emit buffers (scan writes
    # ys in place, no carry copies), with a lax.cond that skips the inner
    # decode once every lane is done — chunks after the deepest lane cost
    # only a [K, L] sentinel fill.
    K = 256
    n_chunks = -(-cap // K)

    def inner(state, _):
        state, emit_val, emit_idx = step_fn(state)
        return state, (emit_val, emit_idx)

    def chunk_active(state):
        return jax.lax.scan(inner, state, None, length=K, unroll=unroll)

    def chunk_skip(state):
        return state, (
            jnp.zeros((K, L), jnp.int32),
            jnp.full((K, L), sentinel, jnp.int32),
        )

    def chunk_body(state, _):
        return jax.lax.cond(
            ~jnp.all(state[4]), chunk_active, chunk_skip, state
        )

    zeros = jnp.zeros(L, jnp.int32)
    init_state = (
        seg_start_bits,
        zeros,
        zeros,
        jnp.zeros((L, n_comp), jnp.int32),
        seg_n_blocks == 0,
        jnp.zeros(L, bool),
    )
    state, (vals, idxs) = jax.lax.scan(
        chunk_body, init_state, None, length=n_chunks
    )

    err = state[5] | ~state[4]  # not done at exit = ran out of steps
    coeffs = (
        jnp.zeros(n_blocks_total * 64, jnp.int32)
        .at[idxs.reshape(-1)]
        .set(vals.reshape(-1), mode="drop")
    )
    return coeffs.reshape(n_blocks_total, 64), err


# ---------------------------------------------------------------------------
# Convenience host API
# ---------------------------------------------------------------------------


def entropy_decode_device(imgs: list[JpegImage]) -> np.ndarray:
    """Decode a batch's scans on the device; returns int32 [total_blocks, 64].

    Raises JpegError if any lane failed (malformed stream) — callers should
    fall back to the host runtime.
    """
    plan = build_segment_plan(imgs)
    coeffs, err = decode_segments(
        jnp.asarray(plan.scan),
        jnp.asarray(plan.seg_start_bits),
        jnp.asarray(plan.seg_block_base),
        jnp.asarray(plan.seg_n_blocks),
        jnp.asarray(plan.rows),
        jnp.asarray(plan.luts),
        jnp.asarray(plan.pattern),
        cap=plan.cap,
        n_blocks_total=plan.n_blocks_total,
    )
    if bool(jax.device_get(jnp.any(err))):
        raise JpegError("device entropy decode failed (malformed scan)")
    return np.asarray(jax.device_get(coeffs))
