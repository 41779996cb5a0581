"""Batched decode engine: the device analog of `batchDecodeKernel`.

The reference's batch layer packs per-image pointers into structs and
launches `batchDecodeKernel<<<B,256>>>` with host extract done serially
beforehand (cuda-decoder/src/parser.cu:663-682,
benchmark_thoughput/benchmark.cu:56-66).  This engine replaces that with a
pipelined three-stage design:

  1. **parse** — marker walk + de-stuff on a host thread pool;
  2. **entropy** — selectable backend:
       - 'host': the native C++ decoder on a thread pool (ctypes releases
         the GIL, OpenMP splits restart segments — the cudaH strategy);
       - 'fsm': the gather-free device FSM (ops/fsm.py) for
         restart-segmented streams;
       - 'oracle': the NumPy reference (debugging);
       - 'auto': picks by a measured host->device link probe — the device
         FSM when the link is slow (uploading dense coefficients would
         strangle the host path), the native host decoder when the link is
         fast and the C++ runtime is available;
  3. **pixels** — the jitted device program (dequant + inverse zigzag +
     integer IDCT + color) vmapped over a geometry bucket, sharded over
     the mesh batch axis (parallel/sharding.py).

Chunks are dispatched to the device asynchronously, so stage 2 of chunk
n+1 overlaps stage 3 of chunk n — the host-level double buffering the
reference prototyped in its pipe1/pipe2 experiments
(legacy_versions/cudaO-implementation/src/parser_pipe2.cu, SURVEY §2.5).

Images are bucketed by `Geometry` (one XLA program per size class —
SURVEY §8 hard-part #3) and chunks are zero-padded to a fixed batch shape
so the jit cache stays small.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import JpegError
from ..io.parser import JpegImage, parse
from ..pipeline import Geometry, _repair
from ..ops.color import unpack_mask
from ..parallel import sharding

_log = logging.getLogger("tpujpeg.batch")

# Host->device bandwidth below which uploading dense coefficients (≈6x the
# compressed bytes as int16) loses to uploading scan bytes + device FSM.
# Not yet tuned on a GPU host (ROADMAP S6).
_LINK_MBPS_FSM_THRESHOLD = 200.0

# How many chunks may be prepared (plan packed + scan bytes staged on
# device) ahead of the dispatch loop: enough to hide build_plan + upload
# behind device time without holding every chunk's lane matrix live.
_PREP_AHEAD = 3
_link_mbps_cache: float | None = None

# Single-pass sync-log speculative path (fsm.decode_speculative_sync)
# as the primary no-restart decoder; 0 reverts to the Jacobi fixed
# point everywhere (A/B and emergency escape hatch).
_SPEC_SYNC = os.environ.get("TPUJPEG_SPEC_SYNC", "1") == "1"


def measured_link_mbps() -> float:
    """One-shot host->device->host bandwidth probe (MB/s), cached.

    Used by backend='auto' and build_plan's split choice: a fast link
    favors the native host decoder, a slow one the scan-upload-only FSM.
    """
    global _link_mbps_cache
    if _link_mbps_cache is None:
        # Two sizes, bandwidth from the DELTA: a single-buffer probe folds
        # the per-dispatch latency into the figure, and on a fast-link /
        # high-latency machine (~5 ms dispatch) that misreads GB/s links
        # as ~200 MB/s — right at the backend='auto' routing threshold.
        small = np.zeros(1 << 16, np.uint8)
        big = np.zeros(4 << 20, np.uint8)

        def roundtrip(buf):
            t0 = time.perf_counter()
            d = jax.device_put(buf)
            np.asarray(jax.device_get(d[-8:]))
            return time.perf_counter() - t0

        # untimed first pass per size: backend init, and the tail slice
        # compiles once per input shape
        roundtrip(small)
        roundtrip(big)
        t_small = min(roundtrip(small) for _ in range(2))
        t_big = min(roundtrip(big) for _ in range(2))
        if t_big > t_small * 1.05:
            _link_mbps_cache = (big.nbytes - small.nbytes) / (
                t_big - t_small
            ) / 1e6
        else:
            # latency so dominant the sizes are indistinguishable: report
            # the raw big-buffer figure (a lower bound)
            _link_mbps_cache = big.nbytes / t_big / 1e6
    return _link_mbps_cache


@dataclass
class BatchStats:
    """Wall-clock per stage for the last decode() call (seconds)."""

    n_images: int = 0
    compressed_bytes: int = 0
    pixels: int = 0
    parse_s: float = 0.0
    entropy_s: float = 0.0
    device_s: float = 0.0
    total_s: float = 0.0
    backend: str = ""
    chunks: int = 0
    repaired_pixels: int = 0
    failures: dict = field(default_factory=dict)  # index -> error message
    # FSM fallback accounting: envelope cliffs must be counted
    fsm_envelope_fallbacks: int = 0   # chunks redone on host: outside envelope
    fsm_k_retries: int = 0            # chunks re-decoded at STEPS_SAFE
    fsm_malformed_fallbacks: int = 0  # chunks redone on host: bad stream
    spec_sync_misses: int = 0         # spec chunks that fell back to Jacobi

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@jax.jit
def _pack_fence(rgb, err_mal, err_env):
    return jnp.stack(
        [
            rgb[..., :1, :1, :1].sum().astype(jnp.int32),
            jnp.any(err_mal).astype(jnp.int32),
            jnp.any(err_env).astype(jnp.int32),
        ]
    )


@dataclass
class _Chunk:
    geom: Geometry
    indices: list[int]
    imgs: list[JpegImage]
    coeffs: np.ndarray | None = None   # [B, n_blocks, 64] int32 (host backend)
    coeffs_dev: object = None          # device coeffs (fsm backend)
    dc_dev: object = None              # resolved DC [B, n_blocks] (fused fsm)
    spec_pending: object = None        # fsm.SpecPending (prepared spec chunk)
    uploaded: object = None            # staged device scan bytes (K retry)
    uploaded_plan: object = None       # fsm.upload_plan result (all groups)
    plan: object = None                # FsmPlan (fsm backend, for K retry)
    plan_future: object = None         # async build_plan+upload (pipelining)
    steps = 0                          # FSM steps spec used (fsm._steps_spec)
    spec_k_retries: int = 0            # inline STEPS_SAFE retries (spec path)
    spec_sync_misses: int = 0          # sync-log resolve misses -> Jacobi
    err_mal: object = None             # device malformed mask (fsm backend)
    err_env: object = None             # device envelope mask (fsm backend)
    out: object = None                 # device (rgb, risk, metrics)
    fence: object = None               # device [3] int32: rgb probe, err bits
    backend: str = ""
    failed: dict | None = None         # local index -> message (skip mode)
    bucketed: bool = False             # geom is a size-class bucket; crop
    # fetched pixels to each image's true (height, width) on host
    rgb_host: list | None = None       # cpu backend: per-image uint8 HWC


class BatchDecoder:
    """Reusable batched decoder; one instance owns its jit caches and pools."""

    def __init__(
        self,
        backend: str = "auto",
        workers: int | None = None,
        chunk_size: int = 32,
        mesh=None,
        strict: bool = True,
        fancy: bool = False,
        size_buckets: bool = False,
    ):
        """size_buckets=True decodes heterogeneous-size corpora with a
        BOUNDED number of compiled programs: images group by size-class
        bucket (pipeline.bucket_geometry) instead of exact geometry, the
        pixel program compiles once per bucket, and outputs crop back to
        each image's true size on host — the recompile-free answer to the
        reference's runtime-value dims (cuda-decoder/src/parser.cu:324-331).
        Bucketed chunks whose images carry row-aligned restart intervals
        (ri == k * mcus_x, the --rst-rows dataset prep) run the fused
        device-FSM bucket program when the backend prefers the FSM
        (fsm/auto-on-slow-link): one compile per (bucket, k), per-image
        extents as runtime vectors (runtime/fused.compiled_fused_bucketed).
        Everything else (no/unaligned restarts, oracle/host backends,
        multi-device meshes) runs the host-entropy bucketed path."""
        if backend not in ("auto", "host", "fsm", "gather", "oracle", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        if size_buckets and backend not in ("auto", "host", "oracle", "fsm"):
            raise ValueError(
                "size_buckets requires backend auto/host/oracle/fsm"
            )
        self.backend = backend
        self.size_buckets = size_buckets
        self.chunk_size = chunk_size
        self.strict = strict
        self.fancy = fancy
        # backend='cpu' never touches a device (the complete native C++
        # decoder) — don't even enumerate them; jax backend init can hang
        # when no accelerator is reachable
        self.mesh = (
            None if backend == "cpu"
            else mesh if mesh is not None
            else sharding.make_mesh(n_stripe=1)
        )
        if workers is None and backend == "cpu":
            # one single-threaded native decode per core (see
            # _process_chunk_cpu); the executor default (cores+4) just
            # adds context-switch pressure on a decode-bound pool
            workers = os.cpu_count() or 4
        self.pool = ThreadPoolExecutor(max_workers=workers)
        # Dedicated two-deep pool for chunk preparation (plan packing +
        # scan upload): sharing the parse pool would FIFO-queue prepares
        # behind every pending parse, stalling the first dispatch.  Depth
        # 2 keeps at most a couple of prepared chunks' scan bytes staged
        # ahead of the device.
        self.prep_pool = ThreadPoolExecutor(max_workers=2)
        self.stats = BatchStats()

    # -- entropy backends ---------------------------------------------------

    def _entropy_host(self, imgs: list[JpegImage]) -> list[np.ndarray]:
        from . import host

        return list(self.pool.map(host.entropy_decode, imgs))

    def _entropy_host_list(self, imgs: list[JpegImage]) -> list[np.ndarray]:
        if self.backend == "oracle":
            from ..oracle import decoder as oracle

            return list(self.pool.map(oracle.entropy_decode, imgs))
        return self._entropy_host(imgs)

    # -- decode -------------------------------------------------------------

    def _chunk_key(self, img: JpegImage) -> tuple:
        """Chunk grouping key; element [0] is always the chunk Geometry.

        size_buckets groups by size-class bucket; when the FSM path will
        take bucketed chunks, the key also carries the restart row count
        k (or None) so each chunk is uniform for the fused bucket
        program (one compile per (bucket, k))."""
        geom = Geometry.of(img)
        if self.size_buckets:
            from ..pipeline import bucket_geometry

            b = bucket_geometry(geom)
            if self._prefers_fsm():
                from ..ops.fsm import bucket_lane_k

                return (b, bucket_lane_k(img))
            return (b,)
        return (geom,)

    def _make_chunks(self, imgs: list[JpegImage]) -> list[_Chunk]:
        buckets: dict[tuple, list[int]] = {}
        for i, img in enumerate(imgs):
            buckets.setdefault(self._chunk_key(img), []).append(i)
        chunks = []
        for (geom, *_rest), idxs in buckets.items():
            # Stride-sorted chunking: the FSM scan serializes one column
            # per byte of the LONGEST restart segment in a chunk, and the
            # butterfly matrices scale with the same stride — grouping
            # similar-length images tightens every chunk but the longest
            # (~14% fewer scan columns on the bench distribution).  Output
            # order is restored through chunk.indices, so sorting is free.
            idxs = sorted(idxs, key=lambda i: _stride_key(imgs[i]))
            for j in range(0, len(idxs), self.chunk_size):
                part = idxs[j : j + self.chunk_size]
                chunks.append(
                    _Chunk(
                        geom, part, [imgs[i] for i in part],
                        bucketed=self.size_buckets,
                    )
                )
        return chunks

    def _pad_batch(self) -> int:
        nb = self.mesh.shape["batch"]
        return -(-self.chunk_size // nb) * nb  # pad to the mesh batch axis

    def _quant_block(self, chunk: _Chunk, B: int) -> np.ndarray:
        quant = np.zeros((B, len(chunk.geom.comps), 64), np.int32)
        for bi, img in enumerate(chunk.imgs):
            quant[bi] = np.stack(
                [img.quant_tables[comp.quant_id] for comp in img.components]
            )
        return quant

    def _process_chunk_host(self, chunk: _Chunk, isolate: bool = False):
        """Host entropy (threads + OpenMP) -> coefficient upload -> pixels.

        The native decoder writes int16 straight into the padded batch
        buffer: no per-image copy, and half the upload bytes (the dominant
        cost of this path at batch scale).  isolate=True decodes failing
        images individually: bad ones yield zero coefficients and land in
        chunk.failed instead of raising (ADVICE r1: skip mode must survive
        entropy-stage failures, not just parse failures)."""
        if chunk.bucketed:
            return self._process_chunk_host_bucketed(chunk, isolate=isolate)
        from . import host

        geom = chunk.geom
        B = self._pad_batch()
        native = host._load_native()

        # pool over images + single-threaded native decodes (see
        # _process_chunk_cpu: image-level parallelism beats stacked teams)
        nt = 1 if len(chunk.imgs) > 1 else 0
        if self.backend == "oracle":
            from ..oracle import decoder as oracle

            entropy_fn = oracle.entropy_decode
        else:
            entropy_fn = functools.partial(host.entropy_decode, threads=nt)

        def one(args):
            bi, img, out16 = args
            try:
                if out16 is not None:
                    native.entropy_decode(img, out=out16, threads=nt)
                    return None
                return entropy_fn(img)
            except JpegError as e:
                from .native.lib import Int16RangeError

                if isinstance(e, Int16RangeError) and out16 is not None:
                    raise  # retried on the int32 path by the caller
                if not isolate:
                    raise
                if chunk.failed is None:
                    chunk.failed = {}
                chunk.failed[bi] = str(e)
                if out16 is not None:
                    out16[:] = 0
                return None

        coeffs = None
        if native is not None and self.backend != "oracle":
            from .native.lib import Int16RangeError

            # np.empty: the native decoder writes every real row in full
            # (it zero-fills internally); only padding rows need clearing.
            coeffs = np.empty((B, geom.n_blocks, 64), np.int16)
            coeffs[len(chunk.imgs) :] = 0
            try:
                list(self.pool.map(
                    one,
                    [(bi, im, coeffs[bi]) for bi, im in enumerate(chunk.imgs)],
                ))
            except Int16RangeError:
                # corrupt-but-decodable stream whose DC walk escapes int16:
                # redo the chunk at int32 so output matches the oracle
                # bit-for-bit (the int16 fast path must never wrap)
                coeffs = None
        if coeffs is None:
            coeffs = np.zeros((B, geom.n_blocks, 64), np.int32)
            if self.backend == "oracle" and not isolate:
                for bi, c in enumerate(self._entropy_host_list(chunk.imgs)):
                    coeffs[bi] = c
            else:
                for bi, c in enumerate(self.pool.map(
                    one, [(bi, im, None) for bi, im in enumerate(chunk.imgs)]
                )):
                    if c is not None:
                        coeffs[bi] = c
        fn = sharding.compiled_batch_decoder(geom, self.mesh, self.fancy)
        chunk.out = fn(jnp.asarray(coeffs), jnp.asarray(self._quant_block(chunk, B)))
        chunk.coeffs = coeffs
        chunk.backend = "oracle" if self.backend == "oracle" else "host"

    def _process_chunk_host_bucketed(self, chunk: _Chunk, isolate: bool):
        """Host entropy for a size-class bucket chunk: mixed exact
        geometries share one compiled pixel program.

        Each image entropy-decodes into its REAL MCU layout (threads +
        OpenMP, as in _process_chunk_host), is zero-padded into the
        bucket's MCU raster on host (pipeline.pad_coeffs_to_bucket — a
        strided numpy copy), and the bucketed pixel program receives the
        true MCU extents as runtime values for the fancy upsampler's edge
        masks.  Crop back to true (height, width) happens at fetch."""
        from . import host
        from ..pipeline import pad_coeffs_to_bucket

        bucket = chunk.geom
        B = self._pad_batch()
        native = host._load_native()
        use16 = native is not None and self.backend != "oracle"

        nt = 1 if len(chunk.imgs) > 1 else 0
        if self.backend == "oracle":
            from ..oracle import decoder as oracle

            entropy_fn = oracle.entropy_decode
        else:
            entropy_fn = functools.partial(host.entropy_decode, threads=nt)

        def one(args):
            bi, img, coeffs, narrow = args
            g = Geometry.of(img)
            try:
                if narrow:
                    tmp = np.empty((g.n_blocks, 64), np.int16)
                    native.entropy_decode(img, out=tmp, threads=nt)
                else:
                    tmp = entropy_fn(img)
            except JpegError as e:
                from .native.lib import Int16RangeError

                if isinstance(e, Int16RangeError) and narrow:
                    raise  # whole chunk retries at int32
                if not isolate:
                    raise
                if chunk.failed is None:
                    chunk.failed = {}
                chunk.failed[bi] = str(e)
                return
            pad_coeffs_to_bucket(g, bucket, tmp, coeffs[bi])

        coeffs = None
        if use16:
            from .native.lib import Int16RangeError

            coeffs = np.zeros((B, bucket.n_blocks, 64), np.int16)
            try:
                list(self.pool.map(
                    one,
                    [(bi, im, coeffs, True)
                     for bi, im in enumerate(chunk.imgs)],
                ))
            except Int16RangeError:
                coeffs = None  # corrupt-but-decodable DC walk: int32 redo
        if coeffs is None:
            coeffs = np.zeros((B, bucket.n_blocks, 64), np.int32)
            list(self.pool.map(
                one,
                [(bi, im, coeffs, False) for bi, im in enumerate(chunk.imgs)],
            ))

        ext = np.tile(
            np.asarray([bucket.mcus_y, bucket.mcus_x], np.int32), (B, 1)
        )
        for bi, img in enumerate(chunk.imgs):
            ext[bi] = (img.mcus_y, img.mcus_x)
        fn = sharding.compiled_batch_decoder(
            bucket, self.mesh, self.fancy, bucketed=True
        )
        chunk.out = fn(
            jnp.asarray(coeffs),
            jnp.asarray(self._quant_block(chunk, B)),
            jnp.asarray(ext),
        )
        chunk.coeffs = coeffs
        chunk.backend = (
            "oracle-bucketed" if self.backend == "oracle" else "host-bucketed"
        )

    def _process_chunk_spec(self, chunk: _Chunk, steps=None) -> bool:
        """Speculative device decode for streams without restart markers
        (the reference's centerpiece, parser.cu:50-208).

        Primary: the single-pass sync-log path (fsm.decode_speculative_sync
        — ONE cold scan whose events are adopted via anchor matching;
        backend 'fsm-spec-sync').  On a resolve miss it falls back to the
        Jacobi fixed point (backend 'fsm-spec', stats.spec_sync_misses).
        Streams denser than the production step budget retry ON DEVICE
        at STEPS_SAFE before any host fallback, mirroring the restart
        path's K retry.  Returns False when the chunk is outside every
        speculative envelope."""
        from ..ops import fsm

        geom = chunk.geom
        B = self._pad_batch()
        # every spec backend below runs device_out over a uniform-geometry
        # batch; a mixed chunk would dispatch a full cold+stitch device
        # scan only to fail host-side (and spuriously count a sync miss)
        # — the check is host-known, so route straight to the fallback
        if len({
            (im.n_mcus, im.blocks_per_mcu) for im in chunk.imgs
        }) != 1:
            return False
        chunk.steps = steps if steps is not None else fsm.STEPS_PRODUCTION
        # a STEPS_SAFE retry (or a cold chunk) has no prepared pending;
        # a prepared one was started at production steps only
        pending = None
        if chunk.spec_pending is not None and steps is None:
            pending = chunk.spec_pending
        chunk.spec_pending = None
        try:
            if _SPEC_SYNC:
                try:
                    sync_pending = (
                        pending
                        if isinstance(pending, fsm.SpecSyncPending)
                        else None
                    )
                    if self.mesh.devices.size == 1:
                        # fused tail: adopt+materialize+gather+pixels in
                        # ONE program, int16 throughout, resolved DC on
                        # the side channel (runtime/fused.py)
                        from . import fused

                        if sync_pending is None:
                            sync_pending = fsm.spec_sync_start(
                                chunk.imgs, steps=chunk.steps
                            )
                        if len(set(
                            int(nb) for nb in sync_pending.plan.img_blocks
                        )) != 1:
                            raise fsm.SpecSyncMiss(
                                "mixed geometry in spec chunk"
                            )
                        rgb, risk, coeffs16, dc, err = (
                            fused.decode_spec_sync_fused(
                                sync_pending, geom,
                                jnp.asarray(self._quant_block(chunk, B)),
                                B, len(chunk.imgs), self.fancy,
                                want_coeffs=self.strict,
                            )
                        )
                        chunk.out = (rgb, risk, None)
                        chunk.coeffs_dev = coeffs16
                        chunk.dc_dev = dc
                        chunk.err_mal = err
                        chunk.err_env = jnp.zeros_like(err)
                        chunk.fence = _pack_fence(
                            rgb, chunk.err_mal, chunk.err_env
                        )
                        chunk.backend = "fsm-spec-sync"
                        return True
                    coeffs_dev, (err_mal, err_env) = (
                        fsm.decode_speculative_sync(
                            chunk.imgs, device_out=True, pad_to=B,
                            steps=chunk.steps, pending=sync_pending,
                        )
                    )
                    chunk.backend = "fsm-spec-sync"
                except fsm.SpecEnvelopeError:
                    if fsm.steps_below_safe(chunk.steps):
                        raise  # outer ladder retries the SYNC at SAFE
                    # env at SAFE can be a broken-chain artifact of the
                    # sync scheme: give the Jacobi its own shot
                    chunk.spec_sync_misses += 1
                    coeffs_dev, (err_mal, err_env) = (
                        fsm.decode_speculative_batch(
                            chunk.imgs, device_out=True, pad_to=B,
                            steps=chunk.steps,
                        )
                    )
                    chunk.backend = "fsm-spec"
                except fsm.SpecSyncMiss:
                    chunk.spec_sync_misses += 1
                    coeffs_dev, (err_mal, err_env) = (
                        fsm.decode_speculative_batch(
                            chunk.imgs, device_out=True, pad_to=B,
                            steps=chunk.steps,
                        )
                    )
                    chunk.backend = "fsm-spec"
            else:
                coeffs_dev, (err_mal, err_env) = fsm.decode_speculative_batch(
                    chunk.imgs, device_out=True, pad_to=B, steps=chunk.steps,
                    pending=(
                        pending if isinstance(pending, fsm.SpecPending)
                        else None
                    ),
                )
                chunk.backend = "fsm-spec"
        except fsm.SpecEnvelopeError:
            if not fsm.steps_below_safe(chunk.steps):
                return False
            chunk.spec_k_retries += 1
            return self._process_chunk_spec(chunk, steps=fsm.STEPS_SAFE)
        except JpegError:
            return False
        fn = sharding.compiled_batch_decoder(geom, self.mesh, self.fancy)
        chunk.out = fn(coeffs_dev, jnp.asarray(self._quant_block(chunk, B)))
        chunk.coeffs_dev = coeffs_dev
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        # write-pass / adopt-checksum errors ride the fence (one combined
        # round-trip); a latched lane falls back to the host in _finish
        chunk.fence = _pack_fence(chunk.out[0], err_mal, err_env)
        return True

    def _prefers_fsm(self) -> bool:
        """Whether this decoder routes chunks to the device FSM first."""
        if self.backend == "cpu":
            return False  # no device on this path
        if self.backend == "fsm":
            return True
        if self.backend != "auto":
            return False
        from . import host

        return (
            host._load_native() is None
            or measured_link_mbps() < _LINK_MBPS_FSM_THRESHOLD
        )

    def _prepare_chunk_fsm(self, chunk: _Chunk):
        """Pool-side chunk preparation: pack the plan and stage its scan
        bytes on the device.  Runs on a worker thread so chunk n+1's
        build_plan + upload overlap chunk n's device stages (the
        reference's pipe2 producer/consumer idea at host level).  Returns
        (plan, uploaded_plan) or the JpegError (callers route those chunks
        to the speculative path)."""
        import jax.numpy as jnp_

        from ..ops import fsm

        try:
            if chunk.bucketed:
                try:
                    plan = fsm.build_plan_bucketed(
                    chunk.imgs, chunk.geom, pad_imgs=self._pad_batch()
                )
                except JpegError as e:
                    # bucketed chunks outside the bucket-FSM envelope go
                    # to the HOST-bucketed path, never the (mixed-
                    # geometry) speculative one
                    return e
                up = tuple(
                    jax.device_put(jnp_.asarray(a))
                    for a in (plan.xs, plan.seg_n, plan.wrap_at, plan.skip)
                )
                return plan, up
            plan = fsm.build_plan(
                chunk.imgs,
                split=measured_link_mbps() < _LINK_MBPS_FSM_THRESHOLD,
            )
        except JpegError:
            # restart-lane packing impossible: this chunk will take the
            # speculative path — dispatch its Jacobi converge NOW so the
            # quota fetch overlaps other chunks' device work
            try:
                if _SPEC_SYNC:
                    return ("spec", fsm.spec_sync_start(chunk.imgs))
                return ("spec", fsm.spec_start(chunk.imgs))
            except JpegError as e2:
                return e2
        return plan, fsm.upload_plan(plan)

    def _process_chunk_fsm_bucketed(self, chunk: _Chunk, steps=None) -> bool:
        """Fused device-FSM decode of a size-class bucket chunk (mixed
        exact geometries, one compile per (bucket, k)): scan bytes up,
        bucket-raster FSM emission, static assemble, bucketed pixel
        program with runtime extents.  Returns False when the chunk is
        outside the bucket-FSM envelope (no/unaligned restarts, exotic
        tables, multi-device mesh) so the caller falls back to the
        host-bucketed path."""
        from ..ops import fsm
        from . import fused

        if self.mesh.devices.size != 1:
            return False  # fused program is single-device
        chunk.steps = steps if steps is not None else fsm.STEPS_PRODUCTION
        if chunk.plan is None and chunk.plan_future is not None:
            res = chunk.plan_future.result()
            chunk.plan_future = None
            if not isinstance(res, JpegError):
                chunk.plan, chunk.uploaded = res
        if chunk.plan is None:
            try:
                chunk.plan = fsm.build_plan_bucketed(
                    chunk.imgs, chunk.geom, pad_imgs=self._pad_batch()
                )
            except JpegError:
                return False
        plan = chunk.plan
        if plan.max_blk * 64 > 32768:
            # lanes longer than 512 blocks are outside the tested
            # materialize envelope (ROADMAP R6) — host-bucketed handles
            # these
            return False
        if chunk.uploaded is None:
            chunk.uploaded = tuple(
                jax.device_put(jnp.asarray(a))
                for a in (plan.xs, plan.seg_n, plan.wrap_at, plan.skip)
            )
        B = self._pad_batch()
        try:
            rgb, risk, coeffs, dc, err_mal, err_env, _ = (
                fused.decode_chunk_bucketed(
                    plan, jnp.asarray(self._quant_block(chunk, B)),
                    chunk.geom, B, self.fancy, chunk.steps,
                    uploaded=chunk.uploaded, want_coeffs=self.strict,
                )
            )
        except Exception as e:  # noqa: BLE001 — a failed COMPILE (e.g.
            # out of device memory on an extreme bucket shape) must drop
            # this chunk to the host-bucketed path, not kill the batch.
            # Logged so genuine programming errors (shape bugs, asserts)
            # never hide as quiet fallbacks.
            _log.warning(
                "bucketed fused decode failed (%s: %s); "
                "falling back to the host-bucketed path",
                type(e).__name__, e,
            )
            return False
        chunk.out = (rgb, risk, None)
        chunk.coeffs_dev = coeffs
        chunk.dc_dev = dc
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        chunk.fence = _pack_fence(rgb, err_mal, err_env)
        chunk.backend = "fsm-bucketed"
        return True

    def _process_chunk_fsm(self, chunk: _Chunk, steps=None) -> bool:
        """Fully device-resident: scan bytes up, FSM decode, device-side
        assemble, pixel program.  Nothing but the scan crosses the host
        boundary.  Streams without restart markers take the speculative
        equal-split device path instead (stats.backend: 'fsm-spec').
        Returns False when the chunk is outside both envelopes (exotic
        tables, oversized segments) so the caller can fall back."""
        from ..ops import fsm

        if chunk.bucketed:
            return self._process_chunk_fsm_bucketed(chunk, steps)
        if chunk.plan is None and chunk.plan_future is not None:
            res = chunk.plan_future.result()
            chunk.plan_future = None
            if isinstance(res, JpegError):
                return self._process_chunk_spec(chunk)
            if isinstance(res, tuple) and res[0] == "spec":
                chunk.spec_pending = res[1]
                return self._process_chunk_spec(chunk)
            chunk.plan, chunk.uploaded_plan = res
        if chunk.plan is not None:
            plan = chunk.plan  # prepared, or K-retry reusing the packed plan
        else:
            try:
                # split lane packing only pays when the upload rides a slow
                # link; on a fast link the second scan dispatch costs more
                # device time than the padding it saves (fsm.build_plan doc)
                plan = fsm.build_plan(
                    chunk.imgs,
                    split=measured_link_mbps() < _LINK_MBPS_FSM_THRESHOLD,
                )
            except JpegError:
                return self._process_chunk_spec(chunk)
        chunk.plan = plan
        chunk.steps = steps if steps is not None else fsm.STEPS_PRODUCTION
        B = self._pad_batch()
        if len(plan.groups) == 1 and self.mesh.devices.size == 1:
            # single chip + single stride group: the whole chunk compiles
            # into ONE program (runtime/fused.py) — fewer dispatches, the
            # dense tensor stays int16, DC rides a 1/64th side channel
            from . import fused

            if chunk.uploaded is None:
                if chunk.uploaded_plan is not None:
                    chunk.uploaded = chunk.uploaded_plan[0][0]
                else:
                    xs, sn = plan.groups[0]
                    chunk.uploaded = (
                        jax.device_put(jnp.asarray(xs)),
                        jax.device_put(jnp.asarray(sn)),
                    )
            rgb, risk, coeffs, dc, err_mal, err_env, _ = (
                fused.decode_chunk_fused(
                    plan, jnp.asarray(self._quant_block(chunk, B)),
                    chunk.geom, B, self.fancy, chunk.steps,
                    uploaded=chunk.uploaded,
                    # coeffs feed strict repair only; skip their device
                    # memory writes when the caller opted out of exactness
                    want_coeffs=self.strict,
                )
            )
            chunk.out = (rgb, risk, None)
            chunk.coeffs_dev = coeffs
            chunk.dc_dev = dc
            chunk.err_mal = err_mal
            chunk.err_env = err_env
            chunk.fence = _pack_fence(rgb, err_mal, err_env)
            chunk.backend = "fsm"
            return True
        if chunk.uploaded_plan is None:
            chunk.uploaded_plan = fsm.upload_plan(plan)
        per_lane, (err_mal, err_env) = fsm.decode_plan(
            plan, uploaded=chunk.uploaded_plan, steps=chunk.steps
        )
        coeffs = fsm.assemble_batched(per_lane, layout=plan.layout, pad_to=B)
        coeffs = coeffs.reshape(B, chunk.geom.n_blocks, 64)
        fn = sharding.compiled_batch_decoder(chunk.geom, self.mesh, self.fancy)
        chunk.out = fn(coeffs, jnp.asarray(self._quant_block(chunk, B)))
        chunk.coeffs_dev = coeffs
        chunk.err_mal = err_mal
        chunk.err_env = err_env
        # One combined completion fence: a real output element plus the
        # error bits, fetched in a single host round-trip.
        rgb = chunk.out[0]
        chunk.fence = _pack_fence(rgb, err_mal, err_env)
        chunk.backend = "fsm"
        return True

    def _process_chunk_gather(self, chunk: _Chunk):
        """The lockstep gather decoder (ops/entropy.py) as a backend: the
        alternative the FSM replaced, kept selectable so the comparison
        stays one flag away (ROADMAP X4)."""
        from ..ops import entropy

        geom = chunk.geom
        B = self._pad_batch()
        coeffs = np.zeros((B, geom.n_blocks, 64), np.int32)
        got = entropy.entropy_decode_device(chunk.imgs)
        coeffs[: len(chunk.imgs)] = got.reshape(len(chunk.imgs), geom.n_blocks, 64)
        fn = sharding.compiled_batch_decoder(geom, self.mesh, self.fancy)
        chunk.out = fn(jnp.asarray(coeffs), jnp.asarray(self._quant_block(chunk, B)))
        chunk.coeffs = coeffs
        chunk.backend = "gather"

    def _process_chunk_cpu(self, chunk: _Chunk, isolate: bool):
        """Complete native C++ decode per image (entropy + pixels, OpenMP),
        threaded across the chunk.  No device, no XLA: the batch form of
        host.decode_cpu (the reference cpp-decoder's role).  Output is
        exact by construction — no risk mask, no repair pass."""
        from . import host

        # Image-level parallelism via the pool beats oversubscribed
        # intra-image OpenMP teams (pool x omp stacked 16+ threads on 4
        # cores); single-image chunks keep the full team.
        nt = 1 if len(chunk.imgs) > 1 else 0

        def one(args):
            bi, img = args
            try:
                return host.decode_cpu(img, fancy=self.fancy, threads=nt)
            except JpegError as e:
                if not isolate:
                    raise
                if chunk.failed is None:
                    chunk.failed = {}
                chunk.failed[bi] = str(e)
                return None

        chunk.rgb_host = list(
            self.pool.map(one, list(enumerate(chunk.imgs)))
        )
        chunk.backend = "cpu"

    def _process_chunk(self, chunk: _Chunk, isolate: bool = False):
        if self.backend == "cpu":
            self._process_chunk_cpu(chunk, isolate)
            return
        if self.backend == "gather":
            self._process_chunk_gather(chunk)
            return
        if self.backend == "fsm":
            if not self._process_chunk_fsm(chunk):
                if chunk.bucketed:
                    # mixed-size corpus with non-FSM-able chunks (no or
                    # unaligned restarts): host-bucketed, not an error
                    self._process_chunk_host(chunk, isolate=isolate)
                    return
                raise JpegError("fsm: chunk outside the FSM decode envelope")
            return
        if self.backend == "auto":
            # Link policy: the device FSM uploads only scan bytes, the host
            # path uploads ~6x the compressed size as coefficients — so a
            # slow link (or no native runtime) means fsm, a fast link with
            # the C++ runtime means host.
            if self._prefers_fsm() and self._process_chunk_fsm(chunk):
                return
        self._process_chunk_host(chunk, isolate=isolate)

    def _dispatch_chunk(self, chunk: _Chunk, isolate: bool) -> None:
        """Dispatch one chunk's entropy + pixel programs (async on device)."""
        try:
            self._process_chunk(chunk, isolate=isolate)
        except JpegError:
            if not isolate:
                raise
            # skip mode: a chunk the chosen backend cannot take (e.g.
            # fsm outside its envelope) falls back to per-image host
            # decode so one bad stream never poisons its chunk
            self._process_chunk_host(chunk, isolate=True)

    def decode_parsed(
        self, imgs: list[JpegImage], fetch: bool = True, on_error: str = "raise"
    ) -> list[np.ndarray] | None:
        """Decode parsed images. fetch=False leaves RGB on device (the
        reference's throughput benchmark also skips the output write,
        benchmark_thoughput/benchmark.cu:80-84).

        on_error='skip' isolates entropy/decode failures per image: failed
        entries yield None and are recorded in stats.failures."""
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        chunks = self._make_chunks(imgs)

        prep = self._prefers_fsm()
        if prep:
            measured_link_mbps()  # probe once before pool threads race it
            for chunk in chunks[:_PREP_AHEAD]:
                chunk.plan_future = self.prep_pool.submit(
                    self._prepare_chunk_fsm, chunk
                )
        t_ent = 0.0
        for i, chunk in enumerate(chunks):
            # rolling window: submitting all prepares up front would stage
            # every chunk's scan bytes on device at once; this bounds the
            # lead (and the staged memory) to _PREP_AHEAD chunks
            if prep and i + _PREP_AHEAD < len(chunks):
                nxt = chunks[i + _PREP_AHEAD]
                nxt.plan_future = self.prep_pool.submit(
                    self._prepare_chunk_fsm, nxt
                )
            t0 = time.perf_counter()
            # async device dispatch: chunk n's device stages overlap chunk
            # n+1's host work (plans + uploads prepared on the pool above)
            self._dispatch_chunk(chunk, isolate)
            t_ent += time.perf_counter() - t0
        return self._finish(chunks, len(imgs), t_start, t_ent, fetch, isolate)

    def _finish(
        self,
        chunks: list[_Chunk],
        n_images: int,
        t_start: float,
        t_ent: float,
        fetch: bool,
        isolate: bool,
    ) -> list[np.ndarray] | None:
        n_env = n_mal = n_k = 0
        t0 = time.perf_counter()
        for chunk in chunks:
            if chunk.fence is not None:
                from ..ops import fsm as _fsm

                flags = np.asarray(jax.device_get(chunk.fence))
                mal, env = bool(flags[1]), bool(flags[2])
                if env and not mal and _fsm.steps_below_safe(chunk.steps):
                    # denser than the fast symbol-step envelope: retry the
                    # whole chunk ON DEVICE at the safe step count before
                    # falling back to the host (spec chunks retry via the
                    # spec path — _process_chunk_fsm would rebuild a
                    # restart plan they cannot have)
                    n_k += 1
                    if chunk.backend.startswith("fsm-spec"):
                        retried = self._process_chunk_spec(
                            chunk, steps=_fsm.STEPS_SAFE
                        )
                    else:
                        # restart and bucketed chunks both re-run through
                        # _process_chunk_fsm (it routes bucketed chunks),
                        # reusing the packed plan + staged scan bytes
                        retried = self._process_chunk_fsm(
                            chunk, steps=_fsm.STEPS_SAFE
                        )
                    if retried:
                        flags = np.asarray(jax.device_get(chunk.fence))
                        mal, env = bool(flags[1]), bool(flags[2])
                if mal or env:
                    # bad stream or outside-envelope stream on the device
                    # path: redo on the host decoder, which raises (or, in
                    # skip mode, records) a precise JpegError per image
                    n_mal += int(mal)
                    n_env += int(env and not mal)
                    self._process_chunk_host(chunk, isolate=isolate)
                    jax.block_until_ready(chunk.out)
            elif chunk.out is not None:
                jax.block_until_ready(chunk.out)
        t_dev = time.perf_counter() - t0
        n_k += sum(c.spec_k_retries for c in chunks)
        n_sync_miss = sum(c.spec_sync_misses for c in chunks)

        self.stats = BatchStats(
            n_images=n_images,
            compressed_bytes=sum(
                im.scan_data.size for c in chunks for im in c.imgs
            ),
            pixels=sum(im.width * im.height for c in chunks for im in c.imgs),
            entropy_s=t_ent,
            device_s=t_dev,
            total_s=time.perf_counter() - t_start,
            backend="+".join(sorted({c.backend for c in chunks})),
            chunks=len(chunks),
            fsm_envelope_fallbacks=n_env,
            fsm_malformed_fallbacks=n_mal,
            fsm_k_retries=n_k,
            spec_sync_misses=n_sync_miss,
        )
        for chunk in chunks:
            if chunk.failed:
                for bi, msg in chunk.failed.items():
                    self.stats.failures[chunk.indices[bi]] = msg
        if not fetch:
            return None

        results: list[np.ndarray | None] = [None] * n_images
        repaired = 0
        for chunk in chunks:
            if chunk.rgb_host is not None:
                # cpu backend: already uint8 HWC, exact by construction
                for bi, i in enumerate(chunk.indices):
                    results[i] = chunk.rgb_host[bi]
                continue
            rgb, risk, _ = chunk.out
            # device rgb is planar [B, 3, H, W]; interleave on host
            rgb_h = np.moveaxis(
                np.asarray(jax.device_get(rgb)), 1, -1
            ).astype(np.int32)
            risk_h = np.asarray(jax.device_get(risk)) if self.strict else None
            coeffs_h = chunk.coeffs
            for bi, i in enumerate(chunk.indices):
                if chunk.failed and bi in chunk.failed:
                    continue
                img = chunk.imgs[bi]
                out = rgb_h[bi]
                if chunk.bucketed:
                    # bucket rasters carry padding; crop to the true image
                    out = out[: img.height, : img.width]
                if self.strict:
                    mask = unpack_mask(risk_h[bi], img.width)[: img.height]
                    if mask.any():
                        if coeffs_h is None:  # fsm path: fetch lazily
                            coeffs_h = np.asarray(
                                jax.device_get(chunk.coeffs_dev)
                            ).astype(np.int32)
                            if chunk.dc_dev is not None:
                                # fused path: dense DC rows are raw DPCM
                                # diffs; the resolved plane rides apart
                                coeffs_h[:, :, 0] = np.asarray(
                                    jax.device_get(chunk.dc_dev)
                                )
                        ci = coeffs_h[bi]
                        if chunk.bucketed:
                            # repair indexes blocks in the REAL MCU layout
                            from ..pipeline import unpad_coeffs_from_bucket

                            ci = unpad_coeffs_from_bucket(
                                Geometry.of(img), chunk.geom, ci
                            )
                        _repair(img, ci, out, mask, fancy=self.fancy)
                        repaired += int(mask.sum())
                results[i] = out.astype(np.uint8)
        self.stats.repaired_pixels = repaired
        self.stats.total_s = time.perf_counter() - t_start
        return results  # type: ignore[return-value]

    def decode(
        self, datas: list[bytes], fetch: bool = True, on_error: str = "raise"
    ):
        """Parse + decode a batch of JPEG byte strings, pipelined.

        Parsing runs on the thread pool while full chunks dispatch to the
        device immediately — chunk n's parse/de-stuff/plan overlaps chunk
        n-1's upload and device stages (the host-level realization of the
        reference's pipe2 producer/consumer experiment,
        legacy_versions/cudaO-implementation/src/parser_pipe2.cu).

        on_error: 'raise' propagates the first malformed stream;
        'skip' isolates failures — bad entries yield None (fetch=True) and
        the failure list lands in stats (the per-item retry/skip policy the
        reference lacks entirely; SURVEY §6 failure detection).
        """
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error={on_error!r}")
        t_start = time.perf_counter()
        isolate = on_error == "skip"
        futs = [
            self.pool.submit(_try_parse if isolate else parse, d)
            for d in datas
        ]
        bad: dict[int, str] = {}
        pos_of: list[int] = []
        n_parsed = 0
        buckets: dict[Geometry, tuple[list, list]] = {}
        chunks: list[_Chunk] = []
        t_parse = 0.0
        t_ent = 0.0

        prep = self._prefers_fsm()
        if prep:
            measured_link_mbps()  # probe once before pool threads race it
        pending: list[_Chunk] = []

        def drain(block: bool) -> None:
            nonlocal t_ent
            while pending:
                if prep:
                    # rolling window: bound the staged lead (and device
                    # memory) to _PREP_AHEAD prepared chunks
                    for c in pending[:_PREP_AHEAD]:
                        if c.plan_future is None and c.plan is None:
                            c.plan_future = self.prep_pool.submit(
                                self._prepare_chunk_fsm, c
                            )
                c = pending[0]
                if (
                    not block
                    and c.plan_future is not None
                    and not c.plan_future.done()
                ):
                    break
                pending.pop(0)
                t0 = time.perf_counter()
                self._dispatch_chunk(c, isolate)
                t_ent += time.perf_counter() - t0

        def flush(key, idxs, ims):
            chunk = _Chunk(
                key[0], list(idxs), list(ims), bucketed=self.size_buckets
            )
            idxs.clear()
            ims.clear()
            pending.append(chunk)
            drain(block=False)
            chunks.append(chunk)

        for i, f in enumerate(futs):
            t0 = time.perf_counter()
            res = f.result()  # later parses keep running on the pool
            t_parse += time.perf_counter() - t0
            if isolate and not isinstance(res, JpegImage):
                bad[i] = res
                continue
            pos_of.append(i)
            j = n_parsed
            n_parsed += 1
            key = self._chunk_key(res)
            idxs, ims = buckets.setdefault(key, ([], []))
            idxs.append(j)
            ims.append(res)
            if len(idxs) == self.chunk_size:
                flush(key, idxs, ims)
        for key, (idxs, ims) in buckets.items():
            if idxs:
                flush(key, idxs, ims)
        drain(block=True)

        out = self._finish(chunks, n_parsed, t_start, t_ent, fetch, isolate)
        self.stats.parse_s = t_parse
        if bad:
            # merge parse failures with decode failures (rebased to the
            # caller's original indices)
            decode_failures = {
                pos_of[j]: msg for j, msg in self.stats.failures.items()
            }
            self.stats.failures = {**bad, **decode_failures}
            if out is not None:
                full: list = [None] * len(datas)
                for j, i in enumerate(pos_of):
                    full[i] = out[j]
                return full
        return out


def _stride_key(img: JpegImage) -> int:
    """Longest restart-segment byte length (the FSM scan stride driver)."""
    offs = img.segment_offsets
    if offs.size <= 1:
        return int(img.scan_data.size)
    ends = np.append(offs[1:], img.scan_data.size)
    return int((ends - offs).max())


def _try_parse(data: bytes):
    try:
        return parse(data)
    except JpegError as e:
        return str(e)
