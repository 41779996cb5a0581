"""Gather-free vectorized entropy decode: the column-synchronous symbol FSM.

The device answer to the reference's parallel Huffman decoder
(cuda-decoder/src/parser.cu:50-208).  The design was first shaped by an
accelerator whose compiler lowered dynamic gather and scatter to slow
per-element loops, so the FSM decoder contains **zero
dynamically-indexed memory ops** (whether a table-lookup decoder now
beats it on the GPU is ROADMAP item X3):

  * lanes  = entropy segments (restart intervals), exactly parallel;
  * the scan walks BYTE COLUMNS of a [stride, lanes] matrix — `lax.scan`
    feeds each lane its next byte with no indexing at all;
  * each lane keeps a 32-bit *bit buffer*; every scan column refills it
    with one byte and then runs K **symbol steps** (not bit steps — this
    is the v2 redesign that cut the op count ~3x): one step decodes a
    whole Huffman code *and* its magnitude bits in one go;
  * the only "table lookup" per step is arithmetic: left-aligned canonical
    Huffman codes are CONTIGUOUS and INCREASING in the 16-bit peek window,
    so (code length, symbol) is a piecewise-affine function of
    `tbl << 16 | peek16`, evaluated as one constant-pivot binary select
    tree returning a packed (length, symbol-base) value — compare/select
    ops, never a memory gather;
  * DC coefficients are emitted as DPCM *differences*; predictors are
    resolved afterwards by one per-lane segmented cumsum on device (the
    reference's 3-thread DC prefix pass, parser.cu:198-206, as one vector
    op).  A size-0 DC difference therefore emits nothing at all;
  * each step additionally consumes a trailing EOB code and a trailing
    size-0 DC code when the next bits match them exactly, so runs of
    empty blocks (flat image regions — the worst case for symbols/byte)
    cost one step per ~1.5 blocks instead of three;
  * decoded coefficients are emitted as packed (block, zigzag, value)
    events into per-step slots (scan ys), then materialized WITHOUT
    scatter by two butterfly networks of uniform rolls + selects:
    a stable compaction (events -> front of each lane column) and a
    monotone spread (event rank -> 64*block + zigzag position).  Both are
    collision-free because per-lane emission order matches coefficient
    order, so targets are strictly increasing.

The result is a decode whose wall-clock scales with vector width (add
lanes = add segments/images) instead of with gather latency, and whose
serial depth is bytes-per-segment — the same quantity the reference's
speculative self-synchronization attacks (SURVEY §2.7).

Bit-exactness contract: identical to tpujpeg.oracle.decoder.entropy_decode
(EXTEND per reference utils.cu:34-41, AC RLE/EOB/ZRL per cpp
parser.cpp:105-142, DC DPCM reset per restart segment).

Envelope: the decoder latches two distinct error classes per lane —
*malformed* (invalid code, coefficient index overrun, truncation) and
*outside-envelope* (more than K symbols/byte sustained long enough to
overflow the 32-bit buffer; conformant but pathological).  Callers fall
back to the host decoder on either, but report them differently.
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import JpegError
from ..io.huffman import HuffmanTable
from ..io.parser import JpegImage

MAX_BLOCKS_PER_LANE = 8191  # blk field is 13 bits in the packed event
MAX_PIECES = 512
STEPS_PER_BYTE = 2   # legacy 1-byte-column spec (speculative path; tests)
STEPS_PRODUCTION = (1, 2)   # production spec: (bytes per scan column,
# symbol steps per column).  (2, 3)'s 1.5 steps/byte and (4, 7)'s 1.75 are
# below the ~2 symbols/byte of q90 noisy content (lanes latch err_env and
# the whole chunk retries at STEPS_SAFE); (2, 4) keeps the 2-steps/byte
# envelope with half the scan trip count.  The bpc > 1 machinery works
# and is kept for sparser content; which spec is fastest on the GPU is
# not measured yet.  Streams denser than 2 symbols/byte sustained latch
# err_env and callers retry at the safe spec below.
STEPS_SAFE = 3       # retry spec: 1-byte columns, 3 steps — the provable
# envelope (compound EOB/DC0 steps keep conformant streams within 3
# symbols/byte; the buffer can lag 24 bits before losing anything)
FLUSH_COLS = 6       # trailing no-refill scan columns so end-of-data lanes
# can drain their buffered bits (see _fsm_scan)


def _steps_spec(steps) -> tuple:
    """Normalize a steps spec -> (bytes_per_col, steps_per_col).

    An int `k` is the legacy 1-byte-column spec (k symbol steps per byte);
    a tuple is (bytes refilled per scan column, symbol steps per column).
    """
    if isinstance(steps, tuple):
        return steps
    return (1, steps)


def steps_below_safe(steps) -> bool:
    """True when retrying at STEPS_SAFE decodes strictly more symbols/byte
    (i.e. an err_env under `steps` is worth one on-device retry)."""
    if not steps:
        return False
    bpc, k = _steps_spec(steps)
    sb, ks = _steps_spec(STEPS_SAFE)
    return k * sb < ks * bpc


INVALID_LEN = 31    # code length marking the invalid top gap of a table


def _selfcheck_enabled() -> bool:
    """Whether materialize_checked verifies materialization with the
    in-program checksum: only when TPUJPEG_SELFCHECK=1 asks for it."""
    return os.environ.get("TPUJPEG_SELFCHECK") == "1"


# ---------------------------------------------------------------------------
# Host-side table compilation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FsmTables:
    """Per-batch Huffman constants, hashable (jit static arg).

    piece_keys   : sorted (tbl << 16 | leftcode16) piece boundaries, where
                   leftcode16 is the code left-aligned in a 16-bit window.
                   Canonical codes tile [0, top) contiguously in this
                   space, so the piece holding a 16-bit peek is the last
                   piece with key <= (tbl << 16 | peek16).
    piece_vals   : packed (length << 17 | base + 0x10000); for a peek in
                   the piece, sym = base + (peek >> (16 - length)).
                   length == INVALID_LEN marks the invalid gap above the
                   last code (streams never produce it; latches err).
    eob_len/code : per table set, the AC table's EOB (sym 0) code, or
                   length 0 when absent.
    dc0_len/code : per table set, the DC table's size-0 (sym 0) code, or
                   length 0 when absent.
    tsel[bim]    : table set (0/1) of the component of MCU block bim.
    comp[bim]    : component index of MCU block bim.
    n_comp       : number of frame components.
    """

    piece_keys: tuple
    piece_vals: tuple
    eob_len: tuple
    eob_code: tuple
    dc0_len: tuple
    dc0_code: tuple
    tsel: tuple
    comp: tuple
    n_comp: int
    # Two-level symbol map (default; TPUJPEG_SYMMAP=0 reverts to the flat
    # piece tree): a per-(table, length) tree — ~49 leaves instead of
    # ~130 — whose leaf packs (length << 18 | adj + 0x20000) with
    # g = code + adj a GLOBAL canonical symbol index, plus symtab ([H][16]
    # nibble grid) looked up by a one-hot bilinear product.  Bit-identical
    # to the piece tree (tests/test_fsm.py::test_symmap_*).  None when off.
    len_keys: tuple = None
    len_vals: tuple = None
    symtab: tuple = None


def _table_pieces(table: HuffmanTable, tbl_id: int):
    """Pieces of one canonical table in left-aligned 16-bit peek space."""
    counts = np.asarray(table.counts, np.int64)
    symbols = np.asarray(table.symbols, np.int64)
    pieces = []  # (key, length, base)
    code = 0
    k = 0
    cover_end = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        if n:
            run_start = 0
            for i in range(1, n + 1):
                if i == n or symbols[k + i] != symbols[k + i - 1] + 1:
                    c0 = code + run_start
                    pieces.append(
                        ((c0 << (16 - length)), length,
                         int(symbols[k + run_start]) - c0)
                    )
                    run_start = i
            k += n
            code += n
            cover_end = code << (16 - length)
        code <<= 1
    if cover_end < (1 << 16):  # invalid top gap (all-ones region, T.81 C.2)
        pieces.append((cover_end, INVALID_LEN, 0))
    keyed = [((tbl_id << 16) | key, (length << 17) | (base + 0x10000))
             for (key, length, base) in pieces]
    return keyed


def _length_map(by_tbl: dict):
    """Per-(table, length) pieces + the global nibble symbol grid.

    Leaf value packs (length << 18) | (adj + 0x20000) with
    g = (peek >> (16 - length)) + adj a global canonical symbol index;
    symtab[g >> 4][g & 15] is the symbol byte (row-padded with zeros).
    Exhaustively bit-identical to the piece tree
    (tests/test_fsm.py::test_symmap_*).
    """
    keys, vals, flat = [], [], []
    for tbl in sorted(by_tbl):
        table = by_tbl[tbl]
        counts = np.asarray(table.counts, np.int64)
        symbols = np.asarray(table.symbols, np.int64)
        code = 0
        k = 0
        cover_end = 0
        for length in range(1, 17):
            n = int(counts[length - 1])
            if n:
                adj = len(flat) - code  # g = code + adj
                keys.append((tbl << 16) | (code << (16 - length)))
                vals.append((length << 18) | (adj + 0x20000))
                flat.extend(int(x) for x in symbols[k : k + n])
                k += n
                code += n
                cover_end = code << (16 - length)
            code <<= 1
        if cover_end < (1 << 16):
            keys.append((tbl << 16) | cover_end)
            vals.append((INVALID_LEN << 18) | 0x20000)
    H = -(-len(flat) // 16)
    grid = np.zeros((H, 16), np.int64)
    grid.reshape(-1)[: len(flat)] = flat
    return (
        tuple(keys),
        tuple(vals),
        tuple(tuple(int(v) for v in row) for row in grid),
    )


_tables_cache: dict = {}
# written from BatchDecoder's thread pools; lock the check-then-insert pair
_tables_lock = threading.Lock()


_SYMMAP = os.environ.get("TPUJPEG_SYMMAP", "1") == "1"


def _tables_key(img: JpegImage) -> tuple:
    return (
        tuple(
            (h, t.counts.tobytes(), t.symbols.tobytes())
            for h, t in sorted(img.huffman.items())
        ),
        tuple((c.dc_table_id, c.ac_table_id, c.h, c.v) for c in img.components),
        _SYMMAP,
    )


def build_tables(img: JpegImage) -> FsmTables:
    """Compile the scan's Huffman tables into FSM constants (cached).

    Raises JpegError when the scan is outside the FSM's envelope (more than
    two table sets per class, or size symbols that overflow the 12-bit
    packed value field) — callers fall back to the host/gather decoders.
    The result is cached on the DHT/SOS content: batches re-encode with one
    table family, and rebuilding the piece list per image was a measurable
    host cost at batch scale.
    """
    key = _tables_key(img)
    with _tables_lock:
        hit = _tables_cache.get(key)
    if hit is not None:
        if isinstance(hit, JpegError):
            raise hit
        return hit
    try:
        tables = _build_tables_uncached(img)
    except JpegError as e:
        with _tables_lock:
            if len(_tables_cache) < 256:
                _tables_cache[key] = e
        raise
    with _tables_lock:
        if len(_tables_cache) < 256:
            _tables_cache[key] = tables
    return tables


def _build_tables_uncached(img: JpegImage) -> FsmTables:
    set_of: dict[int, int] = {}  # table id -> set index (0/1)
    for c in img.components:
        if c.dc_table_id != c.ac_table_id:
            # Table sets pair (dc_i, ac_i); mixed assignments are legal JPEG
            # but rare — fall back rather than widen the select trees.
            raise JpegError("fsm: component uses mismatched dc/ac table ids")
        if c.dc_table_id not in set_of:
            if len(set_of) == 2:
                raise JpegError("fsm: more than two Huffman table sets")
            set_of[c.dc_table_id] = len(set_of)

    pieces: list[tuple[int, int]] = []
    by_tbl: dict[int, HuffmanTable] = {}
    eob_len = [0, 0]
    eob_code = [0, 0]
    dc0_len = [0, 0]
    dc0_code = [0, 0]
    for tid, s in set_of.items():
        dc = img.huffman.get(tid)
        ac = img.huffman.get(0x10 | tid)
        if dc is None or ac is None:
            raise JpegError("fsm: scan references missing DHT table")
        if dc.symbols.size and int(np.max(dc.symbols)) > 11:
            raise JpegError("fsm: DC size symbol > 11 overflows packed event")
        if ac.symbols.size and int(np.max(ac.symbols) & 0x0F) > 10:
            raise JpegError("fsm: AC size symbol > 10 overflows packed event")
        for is_ac, table in ((0, dc), (1, ac)):
            pieces.extend(_table_pieces(table, is_ac * 2 + s))
            by_tbl[is_ac * 2 + s] = table
        eob_len[s] = int(ac.lengths[0])
        eob_code[s] = int(ac.codes[0])
        dc0_len[s] = int(dc.lengths[0])
        dc0_code[s] = int(dc.codes[0])
    pieces.sort()
    if len(pieces) > MAX_PIECES:
        raise JpegError("fsm: Huffman tables too irregular")

    len_keys = len_vals = symtab = None
    if _SYMMAP:
        len_keys, len_vals, symtab = _length_map(by_tbl)

    tsel = []
    comp = []
    for ci, c in enumerate(img.components):
        for _ in range(c.h * c.v):
            tsel.append(set_of[c.dc_table_id])
            comp.append(ci)
    return FsmTables(
        piece_keys=tuple(k for k, _ in pieces),
        piece_vals=tuple(v for _, v in pieces),
        eob_len=tuple(eob_len),
        eob_code=tuple(eob_code),
        dc0_len=tuple(dc0_len),
        dc0_code=tuple(dc0_code),
        tsel=tuple(tsel),
        comp=tuple(comp),
        n_comp=len(img.components),
        len_keys=len_keys,
        len_vals=len_vals,
        symtab=symtab,
    )


# ---------------------------------------------------------------------------
# Host-side segment packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FsmPlan:
    """Device-ready column matrices + lane metadata for one batch.

    Lanes are grouped by segment length (up to two stride classes): one
    outlier segment otherwise forces every lane's scan and upload to its
    stride.  `groups` holds per-group (xs uint8 [Lg, stride_g], seg_n
    int32 [Lg]); `perm[i]` is the row of original lane i in the
    group-concatenated per-lane output (the un-shuffle is one big-row
    gather).
    """

    groups: tuple              # ((xs, seg_n_blocks), ...)
    perm: np.ndarray           # int32 [n_segments]
    tables: FsmTables
    max_blk: int               # max blocks in any lane (static)
    # assembly: per image, (first_lane, n_lanes, blocks_per_full_lane,
    #                       blocks_in_last_lane)
    layout: tuple
    n_blocks_total: int

    # single-group convenience (graft dryrun, white-box tests)
    @property
    def xs(self) -> np.ndarray:
        assert len(self.groups) == 1, "multi-group plan: use .groups"
        return self.groups[0][0]

    @property
    def seg_n_blocks(self) -> np.ndarray:
        assert len(self.groups) == 1, "multi-group plan: use .groups"
        return self.groups[0][1]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stride_bucket(longest: int) -> int:
    # Stride buckets: pow2 up to 1 KiB, then 512-byte steps — the column
    # scan costs wall-clock per column, so coarse pow2 buckets would waste
    # up to half the decode on padding columns.
    stride = 64
    while stride < min(longest, 1024):
        stride *= 2
    if longest > stride:
        stride = _round_up(longest, 512)
    return stride


def _pack_group(seg_bytes, nblocks, idxs):
    stride = _stride_bucket(max(seg_bytes[i].size for i in idxs))
    Lg = _round_up(max(len(idxs), 8), 128)
    xs = np.zeros((Lg, stride), np.uint8)
    # ROW-major [Lg, stride]: the device transposes to scan layout for
    # ~free; transposing here cost ~160 ms of host time per 64-image
    # chunk (60% of build_plan).  The per-row loop stays: 5120 contiguous
    # row memcpys measure 6x faster than a vectorized flat scatter (the
    # 11M-element index build + random-access writes dominate).
    for row, i in enumerate(idxs):
        b = seg_bytes[i]
        xs[row, : b.size] = b
    seg_n = np.zeros(Lg, np.int32)
    seg_n[: len(idxs)] = np.asarray(nblocks, np.int32)[idxs]
    return xs, seg_n


def build_plan(imgs: list[JpegImage], split: bool = True) -> FsmPlan:
    """Pack the restart segments of a batch into grouped lane matrices.

    split=True allows the two-stride-class packing below, which minimizes
    PADDED UPLOAD BYTES (the win behind a slow host->device link).  On the
    device itself a second group costs a whole extra scan dispatch — the
    column scan is latency-bound at ~2.3 us/byte-column, so two groups
    serialize stride_a + stride_b columns where one group scans only
    max(stride) — so callers whose scan bytes are already resident (the
    kernel-only benchmark methodology) or whose link is fast pass
    split=False.
    """
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    bpm = len(pattern0)

    seg_bytes: list[np.ndarray] = []
    nblocks: list[int] = []
    layout = []
    n_blocks_total = 0
    for img in imgs:
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes geometries or Huffman tables")
        offs = img.segment_offsets
        n_seg = offs.size
        n_mcus = img.n_mcus
        ri = img.restart_interval or n_mcus
        need = -(-n_mcus // ri)
        if need > n_seg:
            raise JpegError("fsm: missing restart segments")
        ends = np.append(offs[1:need], img.scan_data.size)
        first = len(seg_bytes)
        scan = img.scan_data
        for s in range(need):
            seg_bytes.append(scan[int(offs[s]) : int(ends[s])])
            nblocks.append(min(ri, n_mcus - s * ri) * bpm)
        rib = ri * bpm
        last = n_mcus * bpm - (need - 1) * rib
        if max(rib, last) > MAX_BLOCKS_PER_LANE:
            raise JpegError("fsm: restart interval too long for packed events")
        layout.append((first, need, rib, last))
        n_blocks_total += n_mcus * bpm

    # Two stride classes: pick the split threshold that minimizes total
    # padded bytes (one outlier segment otherwise forces every lane's
    # upload and scan columns to its stride).  Worth a second dispatch +
    # jit entry only when it saves a real fraction and both groups are
    # substantial.
    lens = np.array([b.size for b in seg_bytes], np.int64)
    top_stride = _stride_bucket(int(lens.max()))
    group_idxs: list[list[int]] = [list(range(len(seg_bytes)))]
    if split and len(seg_bytes) >= 192:
        buckets = np.array([_stride_bucket(int(x)) for x in lens])
        base_cost = len(seg_bytes) * top_stride
        best = (base_cost, None)
        for v in sorted(set(buckets.tolist()))[:-1]:
            n_short = int((buckets <= v).sum())
            if n_short < 96 or len(seg_bytes) - n_short < 8:
                continue
            cost = n_short * v + (len(seg_bytes) - n_short) * top_stride
            if cost < best[0]:
                best = (cost, v)
        if best[1] is not None and best[0] < 0.9 * base_cost:
            v = best[1]
            short = np.flatnonzero(buckets <= v).tolist()
            long = np.flatnonzero(buckets > v).tolist()
            group_idxs = [long, short]

    groups = []
    perm = np.zeros(len(seg_bytes), np.int32)
    base = 0
    for idxs in group_idxs:
        groups.append(_pack_group(seg_bytes, nblocks, idxs))
        for row, i in enumerate(idxs):
            perm[i] = base + row
        base += groups[-1][1].shape[0]

    # Bucket the lane capacity to a multiple of 16 blocks.  Production
    # chunks are bucketed by geometry before planning, so the fused
    # program recompiles per geometry REGARDLESS of this value — a pow2
    # bucket (the r1 choice) bought no compile reuse there and cost up
    # to +6.7% on every M-proportional stage (spread windows, DC cumsum,
    # transpose, assemble input).  The layout-independent _decode_jit
    # still shares compiles across geometries with equal 16-block
    # buckets.
    max_blk = max(16, _round_up(max(nblocks), 16))
    return FsmPlan(
        groups=tuple(groups),
        perm=perm,
        tables=tables,
        max_blk=max_blk,
        layout=tuple(layout),
        n_blocks_total=n_blocks_total,
    )


@dataclass(frozen=True)
class FsmBucketPlan:
    """Bucket-raster lane plan: recompile-free mixed-size FSM decode.

    Every image contributes exactly `lanes_per_img` lanes (zero-quota
    padding lanes beyond its real rows); each lane covers `k` MCU rows of
    its image and emits events at bucket-raster output positions
    (pad_info counters in the scan), so per_lane rows ARE the bucket's
    padded layout and assembly is one static reshape — the jitted
    program's key carries only bucket-level statics, never per-image
    layouts.  Requires row-aligned restart intervals (ri == k * mcus_x,
    the --rst-rows dataset prep); the batch engine keys chunks on
    (bucket, k) and routes anything else to the host-bucketed path.
    """

    xs: np.ndarray            # uint8 [L, stride]
    seg_n: np.ndarray         # int32 [L] real-block quotas
    wrap_at: np.ndarray       # int32 [L] blocks per real MCU row
    skip: np.ndarray          # int32 [L] padding slots after each row
    tables: FsmTables
    k: int                    # MCU rows per lane (uniform across chunk)
    lanes_per_img: int        # uniform lane count per image
    max_blk: int              # k * bucket.mcus_x * bpm (lane capacity)
    extents: np.ndarray       # int32 [n_imgs, 2] true (mcus_y, mcus_x)
    n_imgs: int


def bucket_lane_k(img: JpegImage) -> int | None:
    """MCU rows per restart segment, or None when not row-aligned."""
    ri = img.restart_interval
    if not ri or ri % img.mcus_x:
        return None
    if img.segment_offsets.size < -(-img.n_mcus // ri):
        return None  # missing restart segments
    return ri // img.mcus_x


def build_plan_bucketed(
    imgs: list[JpegImage], bucket, pad_imgs: int | None = None
) -> FsmBucketPlan:
    """Pack a mixed-size chunk into bucket-raster lanes (see FsmBucketPlan).

    `bucket` is the size-class Geometry (pipeline.bucket_geometry); every
    image must fit it, share tables/subsampling, and have the same
    row-aligned restart k.  Raises JpegError otherwise (callers fall back
    to the host-bucketed path).

    pad_imgs: pad the lane count as if the chunk held this many images —
    partial chunks then reuse the full chunk's compiled program instead
    of minting a fresh (L,) jit key per remainder size (the compile
    ladder bound, runtime/ladder.py; padding lanes are inert: zero quota,
    done on the first scan column).
    """
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    bpm = len(pattern0)
    k = bucket_lane_k(imgs[0])
    if k is None:
        raise JpegError("fsm-bucket: restart interval not row-aligned")
    lanes_per_img = -(-bucket.mcus_y // k)
    max_blk = k * bucket.mcus_x * bpm
    if max_blk > MAX_BLOCKS_PER_LANE:
        raise JpegError("fsm-bucket: bucket row capacity overflows events")

    seg_bytes: list[np.ndarray] = []
    quotas: list[int] = []
    wraps: list[int] = []
    skips: list[int] = []
    extents = np.zeros((len(imgs), 2), np.int32)
    for ii, img in enumerate(imgs):
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes subsampling or Huffman tables")
        if bucket_lane_k(img) != k:
            raise JpegError("fsm-bucket: mixed restart row counts")
        if img.mcus_x > bucket.mcus_x or img.mcus_y > bucket.mcus_y:
            raise JpegError("fsm-bucket: image exceeds its bucket")
        ri = k * img.mcus_x
        need = -(-img.n_mcus // ri)
        if need > lanes_per_img:
            raise JpegError("fsm-bucket: image exceeds bucket row count")
        offs = img.segment_offsets
        ends = np.append(offs[1:need], img.scan_data.size)
        scan = img.scan_data
        extents[ii] = (img.mcus_y, img.mcus_x)
        for s in range(lanes_per_img):
            if s < need:
                seg_bytes.append(scan[int(offs[s]) : int(ends[s])])
                quotas.append(min(ri, img.n_mcus - s * ri) * bpm)
            else:
                seg_bytes.append(np.zeros(0, np.uint8))
                quotas.append(0)
            wraps.append(max(img.mcus_x * bpm, 1))
            skips.append((bucket.mcus_x - img.mcus_x) * bpm)

    n_real = len(seg_bytes)
    stride = _stride_bucket(max(max(b.size for b in seg_bytes), 64))
    L = _round_up(
        max(n_real, (pad_imgs or 0) * lanes_per_img, 8), 128
    )
    xs = np.zeros((L, stride), np.uint8)
    for row, b in enumerate(seg_bytes):
        xs[row, : b.size] = b
    seg_n = np.zeros(L, np.int32)
    seg_n[:n_real] = quotas
    wrap_at = np.ones(L, np.int32)
    wrap_at[:n_real] = wraps
    skip = np.zeros(L, np.int32)
    skip[:n_real] = skips
    return FsmBucketPlan(
        xs=xs, seg_n=seg_n, wrap_at=wrap_at, skip=skip, tables=tables,
        k=k, lanes_per_img=lanes_per_img, max_blk=max_blk,
        extents=extents, n_imgs=len(imgs),
    )


# ---------------------------------------------------------------------------
# Select-tree primitives (constant tables, no memory ops)
# ---------------------------------------------------------------------------


def _index_tree(idx: jnp.ndarray, values: list[int]) -> jnp.ndarray:
    """Select values[idx] from constants via a bit-indexed select tree."""
    n = 1
    while n < len(values):
        n *= 2
    vals = [jnp.int32(values[i] if i < len(values) else 0) for i in range(n)]
    bit = 0
    while n > 1:
        b = (idx >> bit) & 1
        vals = [jnp.where(b == 0, vals[2 * i], vals[2 * i + 1]) for i in range(n // 2)]
        n //= 2
        bit += 1
    return vals[0]


def _bst_tree(key: jnp.ndarray, keys: tuple, values: tuple) -> jnp.ndarray:
    """value of the last entry with keys[i] <= key (keys sorted ascending).

    Constant-pivot binary select tree; key must be >= keys[0] for a
    meaningful result (guaranteed: table 0's pieces start at key 0).
    """

    def rec(lo: int, hi: int) -> jnp.ndarray:  # entries [lo, hi)
        if hi - lo == 1:
            return jnp.int32(values[lo])
        mid = (lo + hi) // 2
        return jnp.where(key < keys[mid], rec(lo, mid), rec(mid, hi))

    return rec(0, len(keys))


# ---------------------------------------------------------------------------
# The FSM decode kernel
# ---------------------------------------------------------------------------


def _fsm_scan(
    xs,
    seg_n_blocks,
    tables: FsmTables,
    start_bits=None,
    start_bim=None,
    chunk_bits=None,
    steps=STEPS_PRODUCTION,
    pad_info=None,
    log_anchors: bool = False,
):
    """Run the symbol FSM over byte columns.

    Restart mode (defaults): every lane starts at bit 0 of its row with a
    fresh DC chain.  Speculative mode: `start_bits`/`start_bim` give each
    lane its handoff state (bit offset into its row, MCU block phase) from
    the Jacobi boundary iteration.  DC is always emitted as differences;
    _decode_jit resolves predictors with a per-lane cumsum (restart mode)
    or leaves them raw for the global cumsum (speculative mode).

    `steps` is a spec per _steps_spec: (bytes_per_col, steps_per_col) or a
    legacy int (1-byte columns).  2-byte columns halve the serial column
    count: each column carries a packed byte pair and performs two 8-bit
    refills interleaved with the symbol steps (schedule below).  They
    require restart mode (start_bits None; the speculative path's partial
    first take is per-byte).

    `log_anchors=True` additionally emits per step an int32 *anchor*
    — at a block end, the decoder state that a resumed decode would need
    to be bit-identical from there on: `(bitpos_after_block << 2) | bim`
    (DPCM state excluded by construction: DC is emitted as differences),
    plus the running block count at that boundary.  The single-pass
    speculative path matches lane i's true entry state against lane
    i-1's cold end (see decode_speculative_sync) in these logs to adopt
    cold-decoded events without any re-decode.  ys becomes
    (events, anchors, anchor_blks).

    log_anchors also switches errors from LATCH to RECOVER: a cold
    (misaligned) decode routinely walks into garbage that is denser than
    the step budget or hits the invalid code gap — a latched lane would
    halt before ever self-synchronizing.  Instead the lane drops its
    buffered bits, realigns to the refill frontier (always byte-aligned
    in cold mode), resets the in-block position, and keeps decoding; the
    final carry records the LAST recovery bit position (init -1), and
    the resolve step rejects adoption for any lane that recovered past
    its true entry point (exact-state matching makes earlier recoveries
    irrelevant: the decode is a deterministic function of
    (bitpos, phase)).  err masks return all-False in this mode.

    `pad_info` (optional, int32 [L] pair `(wrap_at, skip)`): bucket-raster
    emission for size-class bucketed decode.  The event's block index
    becomes an OUTPUT position that skips `skip` slots after every
    `wrap_at` completed blocks (one padded MCU row of the bucket grid),
    so the butterflies place coefficients directly into the bucket-padded
    per-lane layout and assembly stays a static reshape.  Targets remain
    strictly increasing, so the networks stay collision-free.  Quotas and
    error logic still count REAL blocks.  Costs ~4 vector ops per symbol
    step; not traced at all when None.

    Returns (events int32 [n_cols, steps_per_col, L],
             (err_malformed, err_envelope) bool [L], state).
    """
    bpc, steps_pc = _steps_spec(steps)
    assert 1 <= bpc <= 4 and steps_pc >= bpc, f"bad steps spec {steps}"
    L = xs.shape[1]
    if bpc > 1:
        assert start_bits is None, "multi-byte columns require restart mode"
        if xs.shape[0] % bpc:
            pad = bpc - xs.shape[0] % bpc
            xs = jnp.concatenate([xs, jnp.zeros((pad, L), xs.dtype)])
        # one int32 column value per byte group, stream order preserved
        # (byte 0 in the high bits; the body peels them high-to-low)
        packed = xs[0::bpc].astype(jnp.int32)
        for b in range(1, bpc):
            packed = (packed << 8) | xs[b::bpc].astype(jnp.int32)
        xs = packed
    n_data_cols = xs.shape[0]
    if FLUSH_COLS:
        # Trailing no-refill columns: a lane that consumed all its data
        # but still holds buffered bits gets FLUSH_COLS * steps_pc extra
        # symbol steps to finish.  Without these, short segments (fewer
        # data columns -> fewer total steps) starve at end-of-data and
        # force a whole-chunk STEPS_SAFE retry.  32 buffered bits hold at
        # most 16 two-bit codes, so 6 columns x 3 steps always suffice.
        xs = jnp.concatenate(
            [xs, jnp.zeros((FLUSH_COLS,) + xs.shape[1:], xs.dtype)]
        )
    bpm = len(tables.comp)
    tsel_list = list(tables.tsel)

    def _tsel_of(b):
        # the standard layout (luma set 0, chroma set 1: tsel = [0,1,..,1])
        # collapses the per-step select tree to one compare; grayscale /
        # single-set scans collapse to a constant
        if all(v == tsel_list[0] for v in tsel_list):
            return jnp.full_like(b, tsel_list[0])
        if tsel_list[0] == 0 and all(v == 1 for v in tsel_list[1:]):
            return (b != 0).astype(jnp.int32)
        return _index_tree(b, tsel_list)
    comp_pad = 0  # comp kept host-side; not needed in the scan (DC = diffs)
    del comp_pad
    zero = jnp.zeros(L, jnp.int32)

    def symbol_step(st):
        (buf, navail, bitpos, k, blk, bim, done, err_mal, err_env,
         end_bits, end_bim, *extra) = st
        padst = tuple(extra[:2]) if pad_info is not None else ()
        rec, rec_pend = (extra[-2], extra[-1]) if log_anchors else (None, None)
        active = ~done & ~err_mal & ~err_env

        # ---- peek the next 16 bits, padding past end-of-buffer with 1s.
        # Padding is safe: if the decoded length <= navail, the top bits
        # are real stream bits, and prefix-freeness makes the code exact.
        sa = jnp.maximum(navail - 16, 0)
        sb = jnp.maximum(16 - navail, 0)
        peek = jnp.where(
            navail >= 16,
            buf >> sa,
            (buf << sb) | ((1 << sb) - 1),
        ) & 0xFFFF

        # ---- one piecewise-affine evaluation -> (code length, symbol)
        is_dc = k == 0
        tsel = _tsel_of(bim)
        tbl = jnp.where(is_dc, tsel, tsel + 2)
        if tables.len_keys is not None:
            # two-level map (default): per-(table, length) tree (~2.7x
            # fewer leaves), then the symbol via a one-hot bilinear over
            # the nibble grid (FsmTables docstring; TPUJPEG_SYMMAP=0
            # reverts to the flat piece tree).  The bf16 product is exact
            # on every backend: grid entries are symbol bytes <= 255 (8
            # significant bits, which bf16 holds) and each one-hot row has
            # exactly one nonzero, so no sum ever rounds
            # (tests/test_fsm.py::test_symmap_bf16_product_exact).
            packed = _bst_tree((tbl << 16) | peek, tables.len_keys,
                               tables.len_vals)
            length = packed >> 18
            adj = (packed & 0x3FFFF) - 0x20000
            code = peek >> jnp.clip(16 - length, 0, 16)
            g = jnp.where(length <= 16, code + adj, 0)
            Hn = len(tables.symtab)
            grid = jnp.asarray(tables.symtab, jnp.bfloat16)
            oh_hi = (
                (g[:, None] >> 4) == jnp.arange(Hn, dtype=jnp.int32)[None, :]
            ).astype(jnp.bfloat16)
            row = oh_hi @ grid                              # [L, 16]
            oh_lo = (
                (g[:, None] & 15) == jnp.arange(16, dtype=jnp.int32)[None, :]
            )
            sym = jnp.sum(
                jnp.where(oh_lo, row, 0), axis=1
            ).astype(jnp.int32)
        else:
            packed = _bst_tree((tbl << 16) | peek, tables.piece_keys,
                               tables.piece_vals)
            length = packed >> 17
            base = (packed & 0x1FFFF) - 0x10000
            code = peek >> jnp.clip(16 - length, 0, 16)
            sym = (base + code) & 0xFF
        size = sym & 15
        run = sym >> 4

        need = length + size
        complete = active & (length <= 16) & (navail >= need)
        bad_code = active & (length > 16) & (navail >= 16)
        if not log_anchors:
            err_mal = err_mal | bad_code

        # ---- magnitude bits + EXTEND (reference utils.cu:34-41)
        mag = (buf >> jnp.clip(navail - need, 0, 31)) & ((1 << size) - 1)
        half = 1 << jnp.maximum(size - 1, 0)
        val = jnp.where(mag >= half, mag, mag - 2 * half + 1)

        # ---- classification + emit (DC emits its DPCM difference;
        # size 0 emits nothing at all — the cumsum supplies the predictor)
        eob = complete & ~is_dc & (sym == 0)
        z = jnp.where(is_dc, zero, k + run)
        bad_z = complete & ~is_dc & (z > 63)
        emit = complete & (size > 0) & ~bad_z
        if not log_anchors:
            err_mal = err_mal | (complete & (size > 0) & bad_z)
        # pad mode: the event's block field is the bucket-raster OUTPUT
        # position (oblk), not the real block count
        eblk = padst[1] if padst else blk
        event = jnp.where(emit, (eblk << 18) | (z << 12) | (val + 2048),
                          jnp.int32(-1))

        k2 = jnp.where(complete,
                       jnp.where(is_dc, 1, jnp.where(eob, 64, z + 1)), k)
        consumed = jnp.where(complete, need, 0)
        navail = navail - consumed
        bitpos = bitpos + consumed

        # ---- trailing EOB: if the block is still open and the next bits
        # are exactly this set's EOB code, consume it now (keeps runs of
        # near-empty blocks inside the K-steps/byte envelope)
        el = _index_tree(tsel, list(tables.eob_len))
        ec = _index_tree(tsel, list(tables.eob_code))
        can_eob = complete & (k2 < 64) & (el > 0) & (navail >= el)
        bits_e = (buf >> jnp.clip(navail - el, 0, 31)) & ((1 << el) - 1)
        eob_fire = can_eob & (bits_e == ec)
        navail = navail - jnp.where(eob_fire, el, 0)
        bitpos = bitpos + jnp.where(eob_fire, el, 0)

        # ---- block / segment bookkeeping
        block_end = (complete & (k2 >= 64)) | eob_fire
        blk2 = blk + block_end.astype(jnp.int32)
        if padst:
            # bucket-raster output counters: after `wrap_at` blocks of a
            # padded MCU row, jump `skip` positions (the bucket's column
            # padding); oblk stays strictly increasing
            ocol, oblk = padst
            wrap_at, skip = pad_info
            ocol2 = ocol + block_end.astype(jnp.int32)
            wrapped = ocol2 >= wrap_at
            padst = (
                jnp.where(wrapped, 0, ocol2),
                oblk + jnp.where(
                    block_end,
                    jnp.where(wrapped, skip + 1, 1),
                    0,
                ),
            )
        bim2 = jnp.where(block_end,
                         jnp.where(bim + 1 == bpm, 0, bim + 1), bim)
        if log_anchors:
            # the resumable state at this block boundary: bit position
            # (post code+EOB, pre any compound DC0 of the NEXT block) and
            # MCU phase; k is 0 at boundaries by construction and DC
            # carries no state (diff emission).  blk2 = cold block count.
            # The phase field is 3 bits: bim reaches bpm-1 = 5 on 4:2:0
            # streams (2 bits aliased phases 4-5 into bitpos — a cold
            # anchor at (X+1, bim-4) would falsely certify stitch target
            # (X, bim) and silently adopt misaligned events).  bpm > 8 is
            # guarded in spec_sync_start.
            anchor = jnp.where(
                block_end, (bitpos << 3) | bim2, jnp.int32(-1)
            )
            anchor_blk = jnp.where(block_end, blk2, 0)
        k3 = jnp.where(block_end, 0, k2)
        done_now = block_end & (blk2 >= seg_n_blocks)
        if chunk_bits is not None:
            # speculative count: stop at the first block boundary at or
            # past the lane's chunk end (the reference's overflow rule,
            # parser.cu:156-173)
            done_now = done_now | (block_end & (bitpos >= chunk_bits))
        done2 = done | done_now
        newly = done2 & ~done
        end_bits = jnp.where(newly, bitpos, end_bits)
        end_bim = jnp.where(newly, bim2, end_bim)

        # ---- trailing size-0 DC of the next block (same envelope logic)
        ts2 = _tsel_of(bim2)
        dl = _index_tree(ts2, list(tables.dc0_len))
        dcc = _index_tree(ts2, list(tables.dc0_code))
        can_dc0 = block_end & ~done2 & (dl > 0) & (navail >= dl)
        bits_d = (buf >> jnp.clip(navail - dl, 0, 31)) & ((1 << dl) - 1)
        dc0_fire = can_dc0 & (bits_d == dcc)
        navail = navail - jnp.where(dc0_fire, dl, 0)
        bitpos = bitpos + jnp.where(dc0_fire, dl, 0)
        k4 = jnp.where(dc0_fire, 1, k3)

        if log_anchors:
            # RECOVER, don't latch: drop the backlog, realign to the
            # refill frontier (bitpos + navail), reset the in-block
            # position, record the recovery site (docstring)
            rec_now = bad_code | bad_z
            bitpos = bitpos + jnp.where(rec_now, navail, 0)
            navail = jnp.where(rec_now, 0, navail)
            k4 = jnp.where(rec_now, 0, k4)
            rec = jnp.maximum(rec, jnp.where(rec_now, bitpos, -1))
            # ys marker: one recovery site per slot.  A step recovery
            # takes this slot; an unsent refill marker re-queues for the
            # next slot so BOTH surface (the span check is an ANY over
            # rows, order-free).
            rec_mark = jnp.where(rec_now, bitpos, rec_pend)
            rec_pend2 = jnp.where(
                rec_now, rec_pend, jnp.full_like(rec_pend, -1)
            )
            st2 = (buf, navail, bitpos, k4, blk2, bim2, done2, err_mal,
                   err_env, end_bits, end_bim, rec, rec_pend2)
            return st2, (event, anchor, anchor_blk, rec_mark)
        st2 = (buf, navail, bitpos, k4, blk2, bim2, done2, err_mal, err_env,
               end_bits, end_bim, *padst)
        return st2, event

    # Per-column schedule: one 8-bit refill before each step sub-batch.
    # bpc>1 interleaves refill(byte b), k_b steps per byte — the per-byte
    # refill keeps the (1, K) envelope semantics (a symbol can need 27
    # bits available; an 8-bit refill is always legal up to 24 bits of
    # backlog, where a 16-bit one would already lose bits at 17) while
    # dividing the serial column count by bpc.  Fractional budgets like
    # (4, 7) = 1.75 steps/byte front-load the steps (k_b non-increasing)
    # to drain backlog before later refills.
    base, extra = divmod(steps_pc, bpc)
    ks = [base + (1 if b < extra else 0) for b in range(bpc)]

    def body(st, col_and_byte):
        col, colv_raw = col_and_byte
        colv = colv_raw.astype(jnp.int32)
        events = []
        for b, kb in enumerate(ks):
            byte = (colv >> (8 * (bpc - 1 - b))) & 0xFF
            (buf, navail, bitpos, k, blk, bim, done, err_mal, err_env,
             end_bits, end_bim, *extra) = st
            active = ~done & ~err_mal & ~err_env
            refill = active & (col < n_data_cols)
            if start_bits is None:
                take = jnp.where(refill, 8, 0)
            else:
                take = jnp.where(
                    refill, 8 - jnp.clip(start_bits - col * 8, 0, 8), 0
                )
            overflow = navail + take > 32
            if log_anchors:
                # recover (see docstring): the backlog a cold garbage
                # interpretation piled up is dropped and the lane resumes
                # at the byte-aligned refill frontier
                spill = active & overflow & (take > 0)
                bitpos = bitpos + jnp.where(spill, navail, 0)
                navail = jnp.where(spill, 0, navail)
                k = jnp.where(spill, 0, k)
                extra = list(extra)
                extra[-2] = jnp.maximum(
                    extra[-2], jnp.where(spill, bitpos, -1)
                )
                extra[-1] = jnp.maximum(
                    extra[-1], jnp.where(spill, bitpos, -1)
                )
                extra = tuple(extra)
                overflow = jnp.zeros_like(overflow)
            else:
                err_env = err_env | (active & overflow & (take > 0))
            take = jnp.where(overflow, 0, take)
            buf = (buf << take) | (byte & ((1 << take) - 1))
            navail = navail + take
            st = (buf, navail, bitpos, k, blk, bim, done, err_mal, err_env,
                  end_bits, end_bim, *extra)
            for _ in range(kb):
                st, ev = symbol_step(st)
                events.append(ev)
        if log_anchors:
            return st, tuple(
                jnp.stack([e[i] for e in events]) for i in range(4)
            )
        return st, jnp.stack(events)

    init = (
        zero,                                    # buf
        zero,                                    # navail
        zero if start_bits is None else start_bits,  # bitpos
        zero,                                    # k
        zero,                                    # blk
        zero if start_bim is None else start_bim,    # bim
        seg_n_blocks == 0,                       # done
        jnp.zeros(L, bool),                      # err_malformed
        jnp.zeros(L, bool),                      # err_envelope
        zero,                                    # end_bits
        zero if start_bim is None else start_bim,    # end_bim
    )
    if pad_info is not None:
        init = init + (zero, zero)               # ocol, oblk
    if log_anchors:
        # last recovery bitpos + a pending refill-recovery marker for the
        # next step's ys slot (the rec ys plane is per step; the refill
        # recovery happens between steps)
        init = init + (jnp.full(L, -1, jnp.int32),
                       jnp.full(L, -1, jnp.int32))
    cols = jnp.arange(xs.shape[0], dtype=jnp.int32)
    st, events = jax.lax.scan(body, init, (cols, xs))
    # A lane undone at end of data is either truncated (it consumed its
    # bits and needs more) or STEP-STARVED (whole bytes still buffered —
    # the K symbol-steps/byte budget ran out, not the data).  The latter
    # is an envelope condition: callers retry at STEPS_SAFE.
    undone = ~st[6]
    starved = undone & (st[1] >= 8)
    if log_anchors:
        # recover mode: nothing latches; an undone/garbage lane surfaces
        # as a resolve miss (end state never matches downstream)
        err_mal = st[7]
        err_env = st[8]
    else:
        err_mal = st[7] | (undone & ~starved)
        err_env = st[8] | starved
    # NB: the full carry is returned (and surfaced through the jit below)
    # on purpose: XLA:CPU (observed on jax 0.9.0) miscompiles scans whose
    # carry outputs are dead — execution spins forever.  Keeping every
    # carry live costs a few [L] vectors and sidesteps the bug.
    return events, (err_mal, err_env), st


# ---------------------------------------------------------------------------
# Butterfly materialization (no scatter)
# ---------------------------------------------------------------------------


def _shift_up(x, d, fill):
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x[d:], pad])


def _shift_down(x, d, fill):
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-d]])


def _off_dtype(bound: int):
    """Narrowest offset dtype for shift distances up to `bound`.

    The butterflies are HBM-bandwidth-bound (each stage re-reads and
    re-writes every carried array), so halving the offset bytes directly
    halves the dominant device cost of materialization.  Validity is
    folded into the offset sign (-1 = empty slot) for the same reason.
    """
    return jnp.int16 if bound < 32768 else jnp.int32


def _compact(valid, payload):
    """Stable per-column compaction of [N, L] via masked power-of-2 shifts.

    Valid entries move to the front of each column preserving order.  The
    move offset (position - rank) is non-decreasing down each column, which
    makes every stage collision-free.  Carries: payload (int32 packed
    event) + offset (int16 when N allows; negative = empty).

    NB: radix stays 2.  A radix-4 variant (half the HBM passes) was tried
    and has concrete routing collisions — with capped or modular digits,
    two entries with distinct increasing targets can select the same
    destination row mid-network (e.g. scale 4: offsets 12 @ p and
    9 @ p+4 both route to p+12) — so do not "optimize" this back in
    without a real proof.
    """
    N = valid.shape[0]
    ot = _off_dtype(N)
    pos = jax.lax.broadcasted_iota(ot, valid.shape, 0)
    rank = jnp.cumsum(valid.astype(ot), axis=0) - valid.astype(ot)
    o = jnp.where(valid, pos - rank, ot(-1))
    p = payload
    d = 1
    while d < N:
        sp = _shift_up(p, d, 0)
        so = _shift_up(o, d, ot(-1))
        move = (so >= 0) & ((so & d) > 0)
        stay = (o >= 0) & ((o & d) == 0)
        p = jnp.where(move, sp, jnp.where(stay, p, 0))
        o = jnp.where(move, so - d, jnp.where(stay, o, ot(-1)))
        d *= 2
    return o >= 0, p


def _spread(valid, payload, target, M):
    """Place entry of rank r at row target[r] of [M, L] (zeros elsewhere).

    Requires per column: targets strictly increasing over valid ranks and
    target >= rank (true for compacted coefficient events), so rightward
    offsets are non-decreasing and stages are collision-free.  Carries:
    payload (int16 coefficient value) + offset (int16 when M allows;
    negative = empty).
    """
    N = valid.shape[0]
    ot = _off_dtype(max(M, N))
    pos = jax.lax.broadcasted_iota(ot, valid.shape, 0)
    o = jnp.where(valid, target.astype(ot) - pos, ot(-1))
    p = payload.astype(jnp.int16)

    def fit(x, fill):
        if M > N:
            pad = jnp.full((M - N,) + x.shape[1:], fill, x.dtype)
            return jnp.concatenate([x, pad])
        return x[:M]

    p, o = fit(p, 0), fit(o, ot(-1))
    d = 1
    while d * 2 < M:
        d *= 2
    while d >= 1:
        sp = _shift_down(p, d, 0)
        so = _shift_down(o, d, ot(-1))
        move = so >= d
        stay = (o >= 0) & (o < d)
        p = jnp.where(move, sp, jnp.where(stay, p, 0))
        o = jnp.where(move, so - d, jnp.where(stay, o, ot(-1)))
        d //= 2
    return jnp.where(o == 0, p, 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# DC predictor resolution (per-lane segmented cumsum)
# ---------------------------------------------------------------------------


def _dc_cumsum(dc: jnp.ndarray, tables: FsmTables, max_blk: int):
    """Per-component DC-difference cumsum down each lane: [L, max_blk].

    Every lane is a restart segment, so its DC chains start at 0 — the
    per-lane cumsum IS the DPCM resolution (reference parser.cu:198-206;
    RST predictor reset per T.81 E.2.4).  Blocks whose DC difference was
    zero emitted no event, so their slot holds 0 and the cumsum carries
    the predictor through — which is why the FSM never emits size-0 DCs.
    """
    L = dc.shape[0]
    bpm = len(tables.comp)
    n_mcu = -(-max_blk // bpm)
    pad = n_mcu * bpm - max_blk
    if pad:
        dc = jnp.concatenate([dc, jnp.zeros((L, pad), dc.dtype)], axis=1)
    dc3 = dc.reshape(L, n_mcu, bpm)
    cols = []
    base = 0
    for ci in range(tables.n_comp):
        nb = sum(1 for c in tables.comp if c == ci)
        sub = dc3[:, :, base : base + nb]  # comp blocks are bim-contiguous
        acc = jnp.cumsum(sub.reshape(L, n_mcu * nb), axis=1)
        cols.append(acc.reshape(L, n_mcu, nb))
        base += nb
    return jnp.concatenate(cols, axis=2).reshape(L, n_mcu * bpm)[:, :max_blk]


def _resolve_dc(per_lane: jnp.ndarray, tables: FsmTables, max_blk: int):
    """Substitute resolved DC predictors into the dense per-lane tensor."""
    dc_new = _dc_cumsum(per_lane[:, :, 0], tables, max_blk)
    return jnp.concatenate([dc_new[:, :, None], per_lane[:, :, 1:]], axis=2)


def materialize_checked(ev: jnp.ndarray, M: int, err_mal: jnp.ndarray):
    """_materialize_events + the optional in-program checksum self-check.

    With TPUJPEG_SELFCHECK=1, verifies that every packed event's value
    landed at its target row: sum(val * (target + 1)) over the event
    stream must equal sum(value * (row + 1)) over the dense tensor, per
    lane, in int32 wraparound arithmetic.  A mismatch latches err_mal for
    the lane, so the caller's fallback machinery turns a corrupted
    materialization into a host redecode instead of silent wrong output.
    It also catches events whose target exceeds M.  Off by default: it
    costs a read of the event and dense matrices per chunk.

    Returns (coeffs_t [M, L] int32, err_mal)."""
    coeffs_t = _materialize_events(ev, M)
    if _selfcheck_enabled():
        valid = ev >= 0
        val = jnp.where(valid, (ev & 0xFFF) - 2048, 0)
        tgt = jnp.where(
            valid, ((ev >> 18) & 0x1FFF) * 64 + ((ev >> 12) & 63), 0
        )
        chk_ev = jnp.sum(val * (tgt + 1), axis=0, dtype=jnp.int32)
        w = (jnp.arange(M, dtype=jnp.int32) + 1)[:, None]
        chk_mat = jnp.sum(
            coeffs_t.astype(jnp.int32) * w, axis=0, dtype=jnp.int32
        )
        err_mal = err_mal | (chk_ev != chk_mat)
    return coeffs_t, err_mal


def _materialize_events(ev: jnp.ndarray, M: int) -> jnp.ndarray:
    """Packed events [N, L] -> dense coefficient rows [M, L] int32, by the
    compact + spread butterfly networks (values fit int16 by construction:
    |val| <= 2047)."""
    valid = ev >= 0
    cv, cp = _compact(valid, ev)
    blk = (cp >> 18) & 0x1FFF
    z = (cp >> 12) & 63
    val = (cp & 0xFFF) - 2048
    target = blk * 64 + z
    return _spread(cv, val, target, M)   # [M, L]


# ---------------------------------------------------------------------------
# Full jitted decode
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("tables", "max_blk", "dc_diff", "steps")
)
def _decode_jit(
    xs,
    seg_n_blocks,
    *,
    tables: FsmTables,
    max_blk: int,
    start_bits=None,
    start_bim=None,
    dc_diff: bool = False,
    steps=STEPS_PRODUCTION,
    pad_info=None,
):
    """FSM + butterflies: (per_lane int32 [L, max_blk, 64], err bool [L]).

    Deliberately independent of the batch's image layout so one compile
    serves every batch with the same (stride, lanes, tables, capacity);
    assembly into [n_blocks, 64] is a cheap layout-keyed step on top.
    The optional start state serves the speculative-split path; dc_diff
    leaves DC as raw differences for it (restart mode resolves DPCM with
    the per-lane cumsum).  pad_info (runtime int32 [L] pair) emits
    bucket-raster output positions (see _fsm_scan).
    """
    events, (err_mal, err_env), scan_state = _fsm_scan(
        xs.T, seg_n_blocks, tables,  # [L, stride] -> scan layout, on device
        start_bits=start_bits, start_bim=start_bim, steps=steps,
        pad_info=pad_info,
    )
    stride, S, L = events.shape
    ev = events.reshape(stride * S, L)
    M = max_blk * 64
    coeffs_t, err_mal = materialize_checked(ev, M, err_mal)
    per_lane = coeffs_t.T.reshape(L, max_blk, 64)
    if not dc_diff:
        per_lane = _resolve_dc(per_lane, tables, max_blk)
    return per_lane, (err_mal, err_env), scan_state


def assemble(per_lane: np.ndarray, layout) -> np.ndarray:
    """Per-lane block rows -> scan-order [n_blocks_total, 64] (host)."""
    parts = []
    for first, n_lanes, rib, last in layout:
        if n_lanes > 1:
            parts.append(
                per_lane[first : first + n_lanes - 1, :rib].reshape(-1, 64)
            )
        parts.append(per_lane[first + n_lanes - 1, :last])
    return np.concatenate(parts) if len(parts) > 1 else np.asarray(parts[0])


@functools.partial(jax.jit, static_argnames=("layout", "pad_to"))
def assemble_batched(per_lane: jnp.ndarray, *, layout, pad_to: int):
    """Device-side assemble for a uniform batch: [pad_to, blocks_img, 64].

    All images must share one per-image layout (the batch engine buckets by
    geometry, so this holds within a chunk).  Keeps the FSM -> pixel-stage
    hand-off entirely on device: the coefficient tensor is ~100x the size
    of the compressed scan it came from.
    """
    per_img = []
    for first, n_lanes, rib, last in layout:
        rows = [per_lane[first : first + n_lanes - 1, :rib].reshape(-1, 64)]
        rows.append(per_lane[first + n_lanes - 1, :last])
        per_img.append(jnp.concatenate(rows) if n_lanes > 1 else rows[-1])
    out = jnp.stack(per_img)
    if pad_to > out.shape[0]:
        pad = jnp.zeros((pad_to - out.shape[0],) + out.shape[1:], out.dtype)
        out = jnp.concatenate([out, pad])
    return out


def upload_plan(plan: FsmPlan):
    """Stage a plan's lane matrices + permutation on the device.

    Separated from decode_plan so benchmarks can exclude the host->device
    transfer, matching the reference's kernel-only timing."""
    return (
        tuple(
            (jax.device_put(jnp.asarray(xs)), jax.device_put(jnp.asarray(sn)))
            for xs, sn in plan.groups
        ),
        jax.device_put(jnp.asarray(plan.perm)),
    )


@jax.jit
def _gather_rows(stacked, perm):
    return jnp.take(stacked, perm, axis=0)


def decode_plan(plan: FsmPlan, uploaded=None, steps=STEPS_PRODUCTION):
    """Run the FSM decoder -> (per_lane [n_segs, max_blk, 64], err masks).

    Rows are in original lane (scan) order; or-ing the masks gives the
    per-lane failure flag.  Each stride group runs as its own scan; the
    group-concatenated output is un-shuffled by one big-row gather
    (`plan.perm`), which measures at the dispatch floor.  steps is the
    symbol-steps-per-byte envelope: callers retry env-flagged work at
    STEPS_SAFE."""
    groups, perm = uploaded if uploaded is not None else upload_plan(plan)
    pls, mals, envs = [], [], []
    for xs_d, sn_d in groups:
        per_lane, (err_mal, err_env), _ = _decode_jit(
            xs_d, sn_d, tables=plan.tables, max_blk=plan.max_blk, steps=steps
        )
        pls.append(per_lane)
        mals.append(err_mal)
        envs.append(err_env)
    if len(groups) == 1:
        # single stride class: rows are already in lane order (identity
        # perm); skip the gather dispatch.  Rows past n_segments are
        # padding lanes (seg_n 0 -> done at init -> no error).
        return pls[0], (mals[0], envs[0])
    pl = jnp.concatenate(pls, axis=0)
    mal = jnp.concatenate(mals)
    env = jnp.concatenate(envs)
    per_lane = _gather_rows(pl, perm)
    errs = _gather_rows(jnp.stack([mal, env], axis=1), perm)
    return per_lane, (errs[:, 0], errs[:, 1])


def entropy_decode_fsm(imgs: list[JpegImage]) -> np.ndarray:
    """Decode a batch's scans with the FSM; int32 [total_blocks, 64].

    Raises JpegError on malformed streams or plans outside the FSM envelope
    (callers fall back to the host runtime).
    """
    plan = build_plan(imgs)
    uploaded = upload_plan(plan)
    for steps in (STEPS_PRODUCTION, STEPS_SAFE):
        per_lane, (err_mal, err_env) = decode_plan(plan, uploaded, steps=steps)
        mal, env = (
            bool(jax.device_get(jnp.any(e))) for e in (err_mal, err_env)
        )
        if mal:
            raise JpegError("fsm decode failed (malformed or truncated scan)")
        if not env:
            return assemble(np.asarray(jax.device_get(per_lane)), plan.layout)
    raise JpegError(
        "fsm: stream outside the decode envelope "
        f"(> {STEPS_SAFE} symbols/byte sustained)"
    )


# ---------------------------------------------------------------------------
# Speculative equal-split decode (streams without restart markers)
# ---------------------------------------------------------------------------
#
# The device rendition of the reference's centerpiece (cuda-decoder/src/
# parser.cu:50-208): split the bitstream at equal byte boundaries, decode
# every chunk in parallel from a guessed start state, and iterate until
# neighboring boundary states agree.  The reference's per-thread overflow
# loop becomes a Jacobi fixed-point over lane handoff states: lane i's
# true start is lane i-1's end, lane 0's start is exact, so after k
# iterations lanes 0..k are exact — and Huffman self-synchronization makes
# convergence take a handful of rounds in practice.  The count pass is the
# same symbol FSM in count mode (stop at the first block boundary at or
# past the chunk end); the final pass reuses the full decoder with
# per-lane block quotas and DC-difference emission, with DPCM resolved by
# one segmented cumsum (the reference's 3-thread DC prefix pass,
# parser.cu:198-206).

SPEC_OVERLAP = 384  # bytes a block may straddle past its chunk (max ~213)


class SpecEnvelopeError(JpegError):
    """Speculative count pass latched envelope lanes: the stream is denser
    than the current symbol-step budget.  Distinct from plain JpegError so
    the batch engine can retry ON DEVICE at STEPS_SAFE instead of falling
    straight back to the host decoder (the restart path already does)."""


@dataclass(frozen=True)
class SpecPlan:
    xs: np.ndarray           # uint8 [chunk+overlap, S]
    chunk_bits: np.ndarray   # int32 [S]
    blk_cap: int
    tables: FsmTables
    chunk_bytes: int
    n_lanes: int             # real lanes (before padding)
    n_blocks_total: int
    bpm: int


@functools.partial(jax.jit, static_argnames=("tables", "blk_cap", "steps"))
def _spec_converge_jit(
    xs, chunk_bits, inherit, max_iters, *, tables, blk_cap,
    steps=STEPS_PRODUCTION,
):
    """Run the Jacobi boundary fixed point ON DEVICE (lax.while_loop).

    Each iteration is one count-mode FSM scan; lane i's next start is
    lane i-1's end (rebased into lane i's row) wherever `inherit` holds.
    Returns (start_bits, start_bim, blk, err_mal, err_env, changed,
    iters, probe): `changed` True means the loop hit `max_iters` without
    converging; the error masks are kept SEPARATE so callers can
    distinguish a malformed stream (host fallback) from an envelope
    overflow (on-device STEPS_SAFE retry).
    The host loop this replaces paid one device program + one fetch PER
    iteration; this is one dispatch total.  `probe` keeps every
    inner-scan carry live (the XLA:CPU dead-carry miscompile note in
    _fsm_scan).
    """
    L = chunk_bits.shape[0]
    stride = xs.shape[1]
    chunk_bytes = stride - SPEC_OVERLAP
    max_start = stride * 8 - 1
    caps = jnp.full((L,), blk_cap, jnp.int32)
    zero = jnp.zeros(L, jnp.int32)

    def count(sb, sm):
        _, (err_mal, err_env), st = _fsm_scan(
            xs.T, caps, tables,
            start_bits=sb, start_bim=sm, chunk_bits=chunk_bits,
            steps=steps,
        )
        probe = (
            st[0] + st[1] + st[2] + st[3] + st[5]
            + st[6].astype(jnp.int32)
        )
        return st[9], st[10], st[4], err_mal, err_env, probe

    def body(c):
        sb, sm, _, _, _, _, it, _ = c
        eb, ebim, blk, err_mal, err_env, probe = count(sb, sm)
        nb = jnp.clip(jnp.roll(eb, 1) - chunk_bytes * 8, 0, max_start)
        nm = jnp.roll(ebim, 1)
        nb = jnp.where(inherit, nb, zero)
        nm = jnp.where(inherit, nm, zero)
        changed = jnp.any((nb != sb) | (nm != sm))
        return (nb, nm, blk, err_mal, err_env, changed, it + 1, probe)

    def cond(c):
        return c[5] & (c[6] < max_iters)

    init = (zero, zero, zero, jnp.zeros(L, bool), jnp.zeros(L, bool),
            jnp.bool_(True), jnp.int32(0), zero)
    sb, sm, blk, err_mal, err_env, changed, it, probe = jax.lax.while_loop(
        cond, body, init
    )
    return sb, sm, blk, err_mal, err_env, changed, it, probe


def build_spec_plan(img: JpegImage, chunk_bytes: int = 2048) -> SpecPlan:
    tables = build_tables(img)
    scan = img.scan_data
    S = max(1, -(-scan.size // chunk_bytes))
    n_blocks = img.n_mcus * img.blocks_per_mcu
    stride = chunk_bytes + SPEC_OVERLAP
    # lanes pad to a multiple of 128: few distinct compile keys, and the
    # lane axis divides any power-of-two device mesh
    L = _round_up(S, 128)
    xs = np.zeros((L, stride), np.uint8)
    chunk_bits = np.zeros(L, np.int32)
    for i in range(S):
        part = scan[i * chunk_bytes : i * chunk_bytes + stride]
        xs[i, : part.size] = part
        chunk_bits[i] = min(chunk_bytes, scan.size - i * chunk_bytes) * 8
    cap = 8
    while cap < min(4 * (n_blocks // S + 1) + 64, MAX_BLOCKS_PER_LANE):
        cap *= 2
    return SpecPlan(
        xs=xs,  # row-major [L, stride]; jits transpose on device
        chunk_bits=chunk_bits,
        blk_cap=cap,
        tables=tables,
        chunk_bytes=chunk_bytes,
        n_lanes=S,
        n_blocks_total=n_blocks,
        bpm=img.blocks_per_mcu,
    )


@dataclass(frozen=True)
class SpecBatchPlan:
    """Speculative plan for a whole batch: every image's equal-split
    chunk rows stacked into ONE lane matrix, so each Jacobi iteration is
    a single device program + a single host round-trip for the batch
    (the per-image loop paid both per image — ruinous over a slow link).
    """

    xs: np.ndarray            # uint8 [L, chunk+overlap]
    chunk_bits: np.ndarray    # int32 [L]
    img_first: np.ndarray     # int32 [n_imgs]
    img_lanes: np.ndarray     # int32 [n_imgs]
    img_blocks: np.ndarray    # int64 [n_imgs]
    blk_cap: int
    tables: FsmTables
    chunk_bytes: int
    n_lanes: int
    bpm: int


def build_spec_plan_batch(
    imgs: list[JpegImage], chunk_bytes: int = 2048
) -> SpecBatchPlan:
    tables = build_tables(imgs[0])
    pattern0 = imgs[0].mcu_block_pattern()
    stride = chunk_bytes + SPEC_OVERLAP
    firsts, lanes, blocks = [], [], []
    total = 0
    for img in imgs:
        if img.mcu_block_pattern() != pattern0 or build_tables(img) != tables:
            raise JpegError("fsm: batch mixes geometries or Huffman tables")
        S = max(1, -(-img.scan_data.size // chunk_bytes))
        firsts.append(total)
        lanes.append(S)
        blocks.append(img.n_mcus * img.blocks_per_mcu)
        total += S
    # lanes pad to a multiple of 128 (see build_spec_plan)
    L = _round_up(total, 128)
    xs = np.zeros((L, stride), np.uint8)
    chunk_bits = np.zeros(L, np.int32)
    for img, first, S in zip(imgs, firsts, lanes):
        scan = img.scan_data
        for i in range(S):
            part = scan[i * chunk_bytes : i * chunk_bytes + stride]
            xs[first + i, : part.size] = part
            chunk_bits[first + i] = (
                min(chunk_bytes, scan.size - i * chunk_bytes) * 8
            )
    cap = 8
    worst = max(
        4 * (nb // S + 1) + 64 for nb, S in zip(blocks, lanes)
    )
    while cap < min(worst, MAX_BLOCKS_PER_LANE):
        cap *= 2
    return SpecBatchPlan(
        xs=xs,
        chunk_bits=chunk_bits,
        img_first=np.asarray(firsts, np.int32),
        img_lanes=np.asarray(lanes, np.int32),
        img_blocks=np.asarray(blocks, np.int64),
        blk_cap=cap,
        tables=tables,
        chunk_bytes=chunk_bytes,
        n_lanes=total,
        bpm=imgs[0].blocks_per_mcu,
    )


@functools.partial(
    jax.jit, static_argnames=("tables", "pad_to", "nb", "n_imgs")
)
def _spec_gather_jit(per_lane, quotas, *, tables, pad_to, nb, n_imgs):
    """Trim lane rows to quotas (one row gather) + resolve DC on device.

    The gather index is built ON DEVICE from the [L] quota vector: lanes
    are image-major and each image's quotas sum to exactly nb, so flat
    block G of the [n_imgs * nb] output lives at lane `lane_of[G]`, slot
    `G - off[lane_of[G]]` where `off` is the quota prefix sum.  lane_of /
    off_of materialize by scattering L lane markers at the prefix sums
    and forward-filling with a cummax — the scatter touches only L
    elements and replaces a host-built [B, nb] int32 index upload (~1/32
    the dense tensor's bytes).
    Zero-quota (padding) lanes park their marker out of bounds and drop.
    """
    L, cap, _ = per_lane.shape
    total = n_imgs * nb
    q = quotas.astype(jnp.int32)
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(q)[:-1].astype(jnp.int32)]
    )
    lanes = jnp.arange(L, dtype=jnp.int32)
    off_m = jnp.where(q > 0, off, total)  # park empty lanes out of bounds
    lane_at = jnp.zeros(total, jnp.int32).at[off_m].max(lanes, mode="drop")
    off_at = jnp.zeros(total, jnp.int32).at[off_m].max(off, mode="drop")
    lane_of = jax.lax.cummax(lane_at)
    off_of = jax.lax.cummax(off_at)
    g = jnp.arange(total, dtype=jnp.int32)
    idx = lane_of * cap + (g - off_of)
    flat = per_lane.reshape(L * cap, 64)
    coeffs = jnp.take(flat, idx, axis=0).reshape(n_imgs, nb, 64)
    dc = _dc_cumsum(coeffs[:, :, 0], tables, nb)
    coeffs = jnp.concatenate([dc[:, :, None], coeffs[:, :, 1:]], axis=2)
    if pad_to > n_imgs:
        pad = jnp.zeros((pad_to - n_imgs, nb, 64), coeffs.dtype)
        coeffs = jnp.concatenate([coeffs, pad])
    return coeffs


@functools.partial(
    jax.jit, static_argnames=("tables", "pad_to", "nb", "n_imgs")
)
def _spec_gather16_jit(per_lane, quotas, *, tables, pad_to, nb, n_imgs):
    """_spec_gather_jit at int16 width: the dense tensor stays int16
    (raw DC diffs) and the resolved DC rides a separate int32 [B, nb]
    side channel for the pixel program's dc= input — the full-tensor
    int32 rewrite was the gather's dominant HBM cost."""
    L, cap, _ = per_lane.shape
    total = n_imgs * nb
    q = quotas.astype(jnp.int32)
    off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(q)[:-1].astype(jnp.int32)]
    )
    lanes = jnp.arange(L, dtype=jnp.int32)
    off_m = jnp.where(q > 0, off, total)
    lane_at = jnp.zeros(total, jnp.int32).at[off_m].max(lanes, mode="drop")
    off_at = jnp.zeros(total, jnp.int32).at[off_m].max(off, mode="drop")
    lane_of = jax.lax.cummax(lane_at)
    off_of = jax.lax.cummax(off_at)
    g = jnp.arange(total, dtype=jnp.int32)
    idx = lane_of * cap + (g - off_of)
    flat = per_lane.reshape(L * cap, 64)
    coeffs = jnp.take(flat, idx, axis=0).reshape(n_imgs, nb, 64)
    dc = _dc_cumsum(coeffs[:, :, 0].astype(jnp.int32), tables, nb)
    if pad_to > n_imgs:
        coeffs = jnp.concatenate(
            [coeffs,
             jnp.zeros((pad_to - n_imgs, nb, 64), coeffs.dtype)]
        )
        dc = jnp.concatenate(
            [dc, jnp.zeros((pad_to - n_imgs, nb), dc.dtype)]
        )
    return coeffs, dc


@jax.jit
def _spec_fetch_pack(blocks, err_mal, err_env, changed, countable):
    """Pack the chunk's single fetch: [L] block counts + 3 flag ints."""
    flags = jnp.stack(
        [
            jnp.any(err_mal & countable),
            jnp.any(err_env & countable),
            changed,
        ]
    ).astype(jnp.int32)
    return jnp.concatenate([blocks, flags])


@dataclass
class SpecPending:
    """In-flight speculative chunk: converge + fetch-pack dispatched, not
    yet fetched.  Lets callers start several chunks' Jacobi fixed points
    back-to-back so each chunk's ~30 ms quota fetch overlaps the next
    chunk's device work instead of stalling the dispatch loop."""

    plan: SpecBatchPlan
    xs: object          # device scan bytes
    sb: object          # device start bits (converged)
    sm: object          # device start phases
    packed: object      # device [L+3]: per-lane blocks + 3 flag ints
    steps: object


def spec_start(
    imgs: list[JpegImage],
    chunk_bytes: int = 2048,
    max_iters: int | None = None,
    plan: SpecBatchPlan | None = None,
    xs_dev=None,
    steps=STEPS_PRODUCTION,
) -> SpecPending:
    """Dispatch a spec chunk's Jacobi converge + quota pack (non-blocking)."""
    if plan is None:
        plan = build_spec_plan_batch(imgs, chunk_bytes)
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    xs = xs_dev if xs_dev is not None else jnp.asarray(plan.xs)
    cbits = jnp.asarray(plan.chunk_bits)
    # a padding/first lane never inherits a predecessor's end state
    inherit = np.ones(L, bool)
    inherit[plan.img_first] = False
    inherit[T:] = False

    iters = max_iters or int(plan.img_lanes.max()) + 1
    sb, sm, blocks, err_mal_c, err_env_c, changed, _, _ = _spec_converge_jit(
        xs, cbits, jnp.asarray(inherit), jnp.int32(iters),
        tables=plan.tables, blk_cap=plan.blk_cap, steps=steps,
    )
    # Count-mode latches on an image's LAST lane are benign (with no
    # quota it runs past the true end into the stream's byte padding;
    # block counts stay correct because the latch happens after the last
    # boundary), so only body lanes classify — last-lane problems surface
    # as quota inconsistency or through the write pass.
    countable = np.ones(L, bool)
    countable[T:] = False
    countable[plan.img_first + plan.img_lanes - 1] = False
    packed = _spec_fetch_pack(
        blocks, err_mal_c, err_env_c, changed, jnp.asarray(countable)
    )
    return SpecPending(plan, xs, sb, sm, packed, steps)


def decode_speculative_batch(
    imgs: list[JpegImage],
    chunk_bytes: int = 2048,
    max_iters: int | None = None,
    device_out: bool = False,
    pad_to: int | None = None,
    plan: SpecBatchPlan | None = None,
    xs_dev=None,
    steps=STEPS_PRODUCTION,
    pending: SpecPending | None = None,
):
    """Entropy-decode a batch of no-restart streams via speculative split.

    The device rendition of the reference centerpiece (parser.cu:50-208) at
    batch granularity: all images' equal-split chunks decode as lanes of
    one matrix; the Jacobi boundary fixed point iterates on the WHOLE
    batch at once (lane i's start <- lane i-1's end within each image;
    each image's lane 0 is exact), so convergence costs one device
    program + one host fetch per iteration for the batch, not per image.

    Returns per-image int32 [n_blocks, 64] zigzag coefficients,
    bit-identical to the oracle.  Raises SpecEnvelopeError when the count
    pass latched envelope lanes under `steps` (callers retry at
    STEPS_SAFE), plain JpegError on malformed streams / non-convergence.

    device_out=True (uniform-geometry batches only) keeps the dense
    tensor on device end to end, with exactly ONE host round-trip for
    the whole chunk: the quota/flag fetch after convergence (~L int32).
    Start states stay on device and feed the write pass directly, and
    the ragged->dense gather index is built ON DEVICE from the quota
    vector (_spec_gather_jit) — the old path fetched sb/sm, re-uploaded
    them, and uploaded a [B, nb] int32 index (~1/32 the dense tensor).
    Write-pass error masks stay on device and ride the caller's chunk
    fence.  The return is a device array [pad_to or B, n_blocks, 64]
    ready for the pixel program.
    """
    if pending is None:
        pending = spec_start(
            imgs, chunk_bytes, max_iters, plan, xs_dev, steps
        )
    plan, xs, sb, sm = pending.plan, pending.xs, pending.sb, pending.sm
    steps = pending.steps
    if device_out and len(set(int(nb) for nb in plan.img_blocks)) != 1:
        raise JpegError("device_out requires a uniform-geometry batch")
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    # THE one host round-trip of the chunk: per-lane block counts + the
    # count-pass error classification + the convergence flag, together.
    # sb/sm stay on device for the write pass.  Callers that start
    # several chunks via spec_start before finishing any (bench
    # run_device_chunks, the batch engine) hide this fetch behind the
    # other chunks' device work.
    fetched = np.asarray(jax.device_get(pending.packed))
    blocks_h = fetched[:L]
    any_mal, any_env, changed_h = (int(v) for v in fetched[L : L + 3])
    if changed_h:
        raise JpegError("speculative split did not converge")
    if any_mal:
        raise JpegError(
            "speculative count pass latched malformed lanes"
        )
    if any_env:
        raise SpecEnvelopeError(
            "speculative count pass latched envelope lanes "
            f"(stream denser than steps={steps})"
        )

    quotas = np.asarray(blocks_h, np.int32).copy()
    quotas[T:] = 0
    for first, S, nb in zip(plan.img_first, plan.img_lanes, plan.img_blocks):
        body = quotas[first : first + S - 1]
        last = int(nb) - int(body.sum())
        # last == 0 is legitimate: when a split boundary falls exactly
        # after the image's final block, the trailing chunk holds only
        # overlap/padding and owns no blocks (zero-quota lanes are inert
        # everywhere downstream: the write pass emits nothing and the
        # device gather parks their markers out of bounds)
        if last < 0 or last > plan.blk_cap or np.any(body >= plan.blk_cap):
            raise JpegError(
                "speculative split found inconsistent block counts"
            )
        quotas[first + S - 1] = last

    # The counting cap carries 4x-average headroom (a 2 KB window of
    # near-empty blocks); after convergence the true per-lane maximum is
    # known, so the write pass sizes its dense tensor to it (pow2 bucket
    # to bound compiles) — typically 2-4x smaller butterflies.
    cap_w = 16
    while cap_w < int(quotas.max(initial=1)):
        cap_w *= 2
    cap_w = min(cap_w, plan.blk_cap)
    quotas_dev = jnp.asarray(quotas)  # [L] int32, rides the dispatch
    per_lane, (err_mal, err_env), _ = _decode_jit(
        xs, quotas_dev,
        tables=plan.tables, max_blk=cap_w,
        start_bits=sb, start_bim=sm,
        dc_diff=True, steps=steps,
    )
    if not device_out and bool(
        jax.device_get(jnp.any(err_mal | err_env))
    ):
        raise JpegError("speculative decode failed (malformed scan)")

    if device_out:
        coeffs = _spec_gather_jit(
            per_lane, quotas_dev, tables=plan.tables,
            pad_to=pad_to or len(imgs),
            nb=int(plan.img_blocks[0]), n_imgs=len(imgs),
        )
        # error masks stay ON DEVICE: callers fold them into their chunk
        # fence (one combined host round-trip) instead of a fetch here
        return coeffs, (err_mal, err_env)

    pl = np.asarray(jax.device_get(per_lane))

    out: list[np.ndarray] = []
    pattern = np.asarray([c for c in plan.tables.comp], np.int32)
    for first, S, nb in zip(plan.img_first, plan.img_lanes, plan.img_blocks):
        coeffs = np.concatenate(
            [pl[first + i, : quotas[first + i]] for i in range(S)]
        )
        # Global DPCM: DC was emitted as differences; per-component cumsum.
        comp_seq = np.tile(pattern, int(nb) // plan.bpm)
        for c in range(plan.tables.n_comp):
            m = comp_seq == c
            coeffs[m, 0] = np.cumsum(coeffs[m, 0])
        out.append(coeffs)
    return out


# ---------------------------------------------------------------------------
# Single-pass speculative decode via self-synchronization logs (round 4)
# ---------------------------------------------------------------------------
#
# The Jacobi fixed point costs 5-6 count scans + 1 write scan per chunk.
# This path does the whole thing in ONE scan, exploiting the same self-synchronization the
# host runtime uses (entropy.cpp decode_noseg_spec) — on device:
#
#   * every lane COLD-decodes its chunk from bit 0, emitting events AND a
#     log of block-boundary anchors (bitpos, MCU phase) with the running
#     block count (log_anchors in _fsm_scan);
#   * lane i's true entry state is lane i-1's cold END state (rebased) —
#     if that (bitpos, phase) appears in lane i's anchor log, lane i's
#     cold trajectory from that block onward IS the true decode, so its
#     already-emitted events are adopted directly: trimmed to blocks
#     >= the matched count and re-based (a pure elementwise pass);
#   * correctness is inductive per image: lane 0 is exact; if every
#     lane's entry hits its log, every adopted suffix is exact.  DC is
#     emitted as stream DIFFS, so no decoder state crosses the boundary;
#   * any miss / cold error / quota inconsistency falls back to the
#     Jacobi path (decode_speculative_batch), which keeps its own
#     STEPS_SAFE retry ladder.  Misses require content whose cold decode
#     fails to self-synchronize within one chunk — rare on real streams
#     (the host runtime measured 47k adopted vs 19 re-decoded blocks).
#
# The anchors only need matching near the chunk head: the true entry is
# at most SPEC_OVERLAP bytes past the boundary, so the match scans only
# the leading event rows (the `rows` computation in spec_sync_start
# covers the stitch window + overlap at the active steps spec).


@dataclass
class SpecSyncPending:
    """In-flight sync-spec chunk: cold+stitch scans dispatched, fetch
    pending."""

    plan: SpecBatchPlan
    ev1: object       # device [N1, L] cold events (pass 1)
    anchors: object   # device [N1, L] pass-1 block-boundary anchors
    ablk: object      # device [N1, L] pass-1 cold block count per anchor
    recm: object      # device [N1, L] pass-1 recovery markers (-1 = none)
    ev2: object       # device [N2, L] stitch events (pass 2)
    end2: object      # device [L] stitch-point bit position
    b1: object        # device [L] pass-1 block count at the stitch point
    blk2: object      # device [L] pass-2 decoded block count
    packed: object    # device [2L + 3]: quotas, hits, flags
    steps: object


# Stitch window: pass 2 re-decodes each lane from its true entry for up
# to this many bytes — enough for Huffman self-synchronization (the host
# runtime measures sync within ~100 bytes) plus the entry offset
# (<= SPEC_OVERLAP).  The pass-2 slice adds SPEC_OVERLAP so the stop
# boundary's straddle always fits.
SPEC_STITCH_BYTES = 256


@functools.partial(
    jax.jit, static_argnames=("tables", "blk_cap", "steps", "anchor_rows")
)
def _spec_sync_scan_jit(
    xs, chunk_bits, inherit, body, *, tables, blk_cap, steps, anchor_rows
):
    """The two speculative passes + resolve, ONE dispatch.

    Pass 1 (cold): every lane decodes its whole chunk from bit 0 with
    recovery-not-latch semantics, logging events and block-boundary
    anchors (bitpos, phase, running count).

    Pass 2 (stitch): every lane re-decodes from its TRUE entry state —
    the predecessor's cold end, available on device via a roll — for up
    to SPEC_STITCH_BYTES, in ordinary latch mode (the true stream errs
    only when genuinely malformed or denser than the step budget).

    Resolve: the stitch pass's end state (a block boundary) is matched
    against the cold pass's anchor log: self-synchronization means the
    two trajectories have merged by then, so the cold EVENTS from that
    anchor onward are the true decode and the lane's full event stream
    is stitch events + re-based cold events — no full-length re-decode
    ever happens.  Correctness is inductive per image (lane 0's entry is
    exact; a hit certifies the lane's end, which is the next lane's
    entry), and the caller requires every lane to hit.

    Returns (ev1, anchors, ablk, recm [N1, L], ev2 [N2, L],
    end2, b1, blk2 [L], packed [2L+3]).
    """
    L = chunk_bits.shape[0]
    chunk_bytes = xs.shape[1] - SPEC_OVERLAP
    caps = jnp.full((L,), blk_cap, jnp.int32)
    (ev3, anc3, abk3, rec3), _, st1 = _fsm_scan(
        xs.T, caps, tables, chunk_bits=chunk_bits, steps=steps,
        log_anchors=True,
    )
    s0, s1, _ = ev3.shape
    ev1 = ev3.reshape(s0 * s1, L)
    anchors = anc3.reshape(s0 * s1, L)
    ablk = abk3.reshape(s0 * s1, L)
    recm = rec3.reshape(s0 * s1, L)
    end1, bim1, cold_blk = st1[9], st1[10], st1[4]
    rec_last = st1[11]

    # true entry per lane = predecessor's cold end (exact iff the
    # predecessor hits — certified chunk-wide by the caller)
    P = jnp.roll(end1, 1) - chunk_bytes * 8
    bim_t = jnp.roll(bim1, 1)
    P = jnp.where(inherit, jnp.maximum(P, 0), 0)
    bim_t = jnp.where(inherit, bim_t, 0)

    w2 = min(SPEC_STITCH_BYTES, chunk_bytes)
    wslice = min(w2 + SPEC_OVERLAP, xs.shape[1])
    xs2 = jax.lax.slice_in_dim(xs, 0, wslice, axis=1)
    cb2 = jnp.minimum(chunk_bits, w2 * 8)
    ev2_3, (em2, ee2), st2 = _fsm_scan(
        xs2.T, caps, tables, start_bits=P, start_bim=bim_t,
        chunk_bits=cb2, steps=steps,
    )
    t0, t1, _ = ev2_3.shape
    ev2 = ev2_3.reshape(t0 * t1, L)
    end2, bim2e, blk2 = st2[9], st2[10], st2[4]

    # membership: has the cold trajectory visited the stitch state?
    # (3-bit phase field, matching the anchor packing in _fsm_scan)
    target = (end2 << 3) | bim2e
    rows = min(anchor_rows, anchors.shape[0])
    a = jax.lax.slice_in_dim(anchors, 0, rows, axis=0)
    ab = jax.lax.slice_in_dim(ablk, 0, rows, axis=0)
    match = a == target[None, :]
    synced = jnp.any(match, axis=0)
    b1 = jnp.max(jnp.where(match, ab, 0), axis=0)
    quota = blk2 + jnp.maximum(cold_blk - b1, 0)

    # quick classifications for the retry ladder.  Envelope pressure =
    # the TRUE stream runs denser than the step budget: a pass-2 latch
    # on a body lane (pass 2 decodes the true stream), or a pass-1
    # recovery past the stitch point on a lane that SYNCED (its cold
    # trajectory from there IS the true stream).  A late recovery on an
    # UNSYNCED lane is just cold garbage -> plain miss.
    deep = synced & (rec_last > end2) & body
    env = jnp.any((ee2 & body & ~em2) | deep)
    mal = jnp.any(em2 & body)
    # NB: a lane whose whole span fits the stitch window still needs
    # membership when it has a SUCCESSOR — the successor's entry is this
    # lane's COLD end, which only the anchor match certifies (a pass-2-
    # only certificate says nothing about the cold trajectory).  Lanes
    # with no successor (each image's LAST lane) are exempted HOST-side:
    # their pass 2 prefix is adopted against the image-remainder quota.
    hit = synced & ~(em2 | ee2) & ~deep
    probe = jnp.sum(
        st1[0] + st1[3] + st1[5] + st2[0] + st2[3] + st2[5],
        dtype=jnp.int32,
    )
    # blk2 rides the fetch: SHORT last lanes (whole remainder inside the
    # stitch window) validate host-side as blk2 >= image remainder —
    # their pass 2 legitimately runs past the stream end into padding,
    # where latches/garbage say nothing about the true prefix
    packed = jnp.concatenate(
        [
            quota,
            hit.astype(jnp.int32),
            blk2,
            jnp.stack(
                [mal.astype(jnp.int32), env.astype(jnp.int32), probe]
            ),
        ]
    )
    return ev1, anchors, ablk, recm, ev2, end2, b1, blk2, packed


@functools.partial(
    jax.jit,
    static_argnames=("tables", "pad_to", "nb", "n_imgs", "cap_w"),
)
def _spec_sync_assemble_jit(
    ev1, anchors, ablk, recm, ev2, end2, b1, blk2, quotas,
    *, tables, pad_to, nb, n_imgs, cap_w
):
    """Merge stitch + adopted cold events, materialize, ragged-gather
    into the dense per-image tensor, resolve DC.

    Validity per lane (latched into the returned err mask, which rides
    the caller's fence): the (quota - blk2)-th adopted cold block's
    anchor must exist at bit position E, and NO pass-1 recovery marker
    may lie in (end2, E] — a recovery there would have corrupted the
    adopted events (last lanes recover legitimately in the zero padding
    BEYOND E; their quota is the host-computed image remainder)."""
    L = ev1.shape[1]
    take2 = jnp.minimum(blk2, quotas)
    rest = jnp.maximum(quotas - blk2, 0)

    v2 = ev2 >= 0
    blk2ev = (ev2 >> 18) & 0x1FFF
    keep2 = v2 & (blk2ev < take2[None, :])
    part2 = jnp.where(keep2, ev2, jnp.int32(-1))

    v1 = ev1 >= 0
    blk1ev = (ev1 >> 18) & 0x1FFF
    keep1 = (
        v1 & (blk1ev >= b1[None, :]) & (blk1ev < (b1 + rest)[None, :])
    )
    # re-base: final block index = blk1 - b1 + blk2 (the +-(d<<18) only
    # touches bits >= 18: the low fields are untouched by construction)
    part1 = jnp.where(
        keep1, ev1 - ((b1 - blk2)[None, :] << 18), jnp.int32(-1)
    )
    ev = jnp.concatenate([part2, part1], axis=0)

    # adopted-span validity
    big = jnp.int32(0x7FFFFFFF)
    at_end = (anchors >= 0) & (ablk == (b1 + rest)[None, :])
    E = jnp.min(jnp.where(at_end, anchors >> 3, big), axis=0)
    found = (rest == 0) | (E < big)
    bad_span = (rest > 0) & jnp.any(
        (recm > end2[None, :]) & (recm <= E[None, :]), axis=0
    )
    err = (quotas > 0) & (~found | bad_span)

    # merged stream keeps the emission contract: adopted blocks
    # [0, take2) then rebased stitch blocks [blk2, ...) — monotone per
    # lane, and compact squeezes the interspersed invalid rows
    coeffs_t, err = materialize_checked(ev, cap_w * 64, err)
    per_lane = coeffs_t.T.reshape(L, cap_w, 64)
    coeffs, dc = _spec_gather16_jit(
        per_lane, quotas, tables=tables, pad_to=pad_to, nb=nb, n_imgs=n_imgs
    )
    return coeffs, dc, err


class SpecSyncMiss(JpegError):
    """The single-pass sync resolve could not adopt every lane (cold
    decode failed to self-synchronize, or block counts were inconsistent)
    — callers fall back to the Jacobi converge path."""


def spec_sync_start(
    imgs: list[JpegImage],
    chunk_bytes: int = 1024,
    plan: SpecBatchPlan | None = None,
    xs_dev=None,
    steps=STEPS_PRODUCTION,
) -> SpecSyncPending:
    """Dispatch a chunk's single cold scan + resolve (non-blocking)."""
    if plan is None:
        plan = build_spec_plan_batch(imgs, chunk_bytes)
    if plan.bpm > 8:
        # the anchor packing carries a 3-bit MCU phase; exotic
        # subsampling with > 8 blocks/MCU would alias phases into the
        # bit-position field — route those to the Jacobi path, whose
        # state comparison is unpacked
        raise SpecSyncMiss("spec-sync: > 8 blocks per MCU")
    L = plan.chunk_bits.shape[0]
    xs = xs_dev if xs_dev is not None else jnp.asarray(plan.xs)
    inherit = np.ones(L, bool)
    inherit[plan.img_first] = False
    inherit[plan.n_lanes:] = False
    body = np.zeros(L, bool)
    body[: plan.n_lanes] = True
    body[plan.img_first + plan.img_lanes - 1] = False
    bpc, spc = _steps_spec(steps)
    rows = (SPEC_STITCH_BYTES + SPEC_OVERLAP + 64) * 2 * spc // (bpc * 2)
    ev1, anchors, ablk, recm, ev2, end2, b1, blk2, packed = (
        _spec_sync_scan_jit(
            xs, jnp.asarray(plan.chunk_bits), jnp.asarray(inherit),
            jnp.asarray(body),
            tables=plan.tables, blk_cap=plan.blk_cap, steps=steps,
            anchor_rows=rows,
        )
    )
    return SpecSyncPending(
        plan, ev1, anchors, ablk, recm, ev2, end2, b1, blk2, packed, steps
    )


def spec_sync_resolve_host(pending: SpecSyncPending):
    """THE one host round-trip of the sync path: fetch quotas/hits,
    resolve last-lane remainders, validate the per-image chain.

    Returns (quotas int32 [L], cap_w) or raises SpecEnvelopeError /
    SpecSyncMiss for the caller's retry ladder."""
    plan = pending.plan
    T = plan.n_lanes
    L = plan.chunk_bits.shape[0]
    fetched = np.asarray(jax.device_get(pending.packed))
    quotas = fetched[:L].astype(np.int32)
    hits = fetched[L : 2 * L].astype(bool)
    blk2 = fetched[2 * L : 3 * L].astype(np.int32)
    any_mal, any_env = (int(v) for v in fetched[3 * L : 3 * L + 2])
    quotas[T:] = 0
    hits[T:] = True

    w2 = min(SPEC_STITCH_BYTES, plan.chunk_bytes)
    ok = True
    for first, S, nb in zip(
        plan.img_first, plan.img_lanes, plan.img_blocks
    ):
        # a LAST lane's device count runs past the stream end into the
        # zero padding (garbage): its true quota is the image remainder,
        # and its adopted span is validated precisely in the assemble
        # step (quota-th anchor + recovery markers).  When the whole
        # remainder fits the stitch window, pass 2's true prefix is the
        # complete decode — valid iff it counted at least the remainder
        # before any padding latch.
        li = first + S - 1
        body_sum = int(quotas[first:li].sum())
        last = int(nb) - body_sum
        quotas[li] = last
        if int(plan.chunk_bits[li]) <= w2 * 8:
            hits[li] = blk2[li] >= last
        span = quotas[first : first + S]
        if (
            last < 0
            or int(span.max(initial=0)) > plan.blk_cap
            or int(span.min(initial=0)) < 0
        ):
            ok = False
            break
    ok = ok and bool(hits[:T].all())
    if not ok:
        if any_env:
            # density pressure: let the caller retry the LADDER at
            # STEPS_SAFE (the provable envelope) before the Jacobi path
            raise SpecEnvelopeError(
                "spec-sync cold pass latched envelope lanes"
            )
        raise SpecSyncMiss(
            "spec-sync: cold decode failed to resolve every lane"
        )

    cap_w = 16
    while cap_w < int(quotas.max(initial=1)):
        cap_w *= 2
    cap_w = min(cap_w, plan.blk_cap)
    return quotas, cap_w


def decode_speculative_sync(
    imgs: list[JpegImage],
    chunk_bytes: int = 1024,
    device_out: bool = True,
    pad_to: int | None = None,
    plan: SpecBatchPlan | None = None,
    xs_dev=None,
    steps=STEPS_PRODUCTION,
    pending: SpecSyncPending | None = None,
):
    """Single-pass speculative batch decode (see module note above).

    Returns (coeffs device [pad_to, nb, 64], err_mask [L]) like
    decode_speculative_batch(device_out=True).  Raises SpecSyncMiss when
    any lane failed to resolve (callers fall back to the Jacobi path) and
    SpecEnvelopeError when the cold pass classified envelope pressure.
    """
    if pending is None:
        pending = spec_sync_start(imgs, chunk_bytes, plan, xs_dev, steps)
    plan = pending.plan
    if device_out and len(set(int(nb) for nb in plan.img_blocks)) != 1:
        raise JpegError("device_out requires a uniform-geometry batch")
    quotas, cap_w = spec_sync_resolve_host(pending)
    coeffs16, dc, err = _spec_sync_assemble_jit(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        jnp.asarray(quotas),
        tables=plan.tables, pad_to=pad_to or len(imgs),
        nb=int(plan.img_blocks[0]), n_imgs=len(imgs), cap_w=cap_w,
    )
    # public contract: int32 coefficients with DC resolved (the fused
    # engine/bench paths consume (coeffs16 raw-DC, dc) directly instead)
    coeffs = jnp.concatenate(
        [dc[:, :, None], coeffs16[:, :, 1:].astype(jnp.int32)], axis=2
    )
    if not device_out:
        got = np.asarray(jax.device_get(coeffs))
        if bool(np.asarray(jax.device_get(err)).any()):
            raise SpecSyncMiss("spec-sync: materialization checksum failed")
        return [
            got[i, : int(nb)] for i, nb in enumerate(plan.img_blocks)
        ]
    # the err mask rides the caller's fence like the Jacobi write pass's
    return coeffs, (err, jnp.zeros_like(err))


def decode_speculative(
    img: JpegImage, chunk_bytes: int = 2048, max_iters: int | None = None
) -> np.ndarray:
    """Entropy-decode one no-restart stream on device via speculative
    split (see decode_speculative_batch).  Returns int32 [n_blocks, 64]
    zigzag coefficients, bit-identical to the oracle.  Streams denser
    than the production step budget retry once at STEPS_SAFE."""
    try:
        return decode_speculative_batch([img], chunk_bytes, max_iters)[0]
    except SpecEnvelopeError:
        return decode_speculative_batch(
            [img], chunk_bytes, max_iters, steps=STEPS_SAFE
        )[0]
