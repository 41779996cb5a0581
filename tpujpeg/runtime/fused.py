"""Fused per-chunk decode: FSM -> materialize -> assemble -> pixels, ONE
XLA program.

The three-program chain (fsm._decode_jit, fsm.assemble_batched, the pixel
program) pays a dispatch per program and round-trips the dense
coefficient tensor through device memory twice at int32 width (~630 MB
per 64-image 640^2 chunk).  This module compiles the whole chunk into one
jitted program instead (the answer to the reference's single fused
`decodeKernel`, cuda-decoder/src/parser.cu:577-661, but covering entropy
decode too, which the reference runs in a separate kernel):

  * the FSM scan and butterfly materialization run exactly as in
    fsm._decode_jit;
  * DC stays as DPCM differences in the dense tensor; the resolved
    predictors ride a separate [L, max_blk] cumsum and substitute into
    the dequant's DC plane (pipeline._idct_planar dc=), replacing a
    full-tensor rewrite with a 1/64th-sized side channel;
  * assembly into per-image rows is slicing/reshaping that XLA fuses
    into the pixel stage's transposes — no standalone pass.

Stages carry named scopes (fsm_scan, materialize, assemble, pixels) so a
profiler trace attributes device time to them.

The program is keyed on (tables, max_blk, layout, pad_to, geometry),
i.e. one compile per (geometry x restart-layout) bucket — coarser reuse
than the layout-independent fsm._decode_jit, but the batch engine
buckets chunks by geometry anyway.  Single-group plans only; the
grouped-stride path keeps the staged chain (fsm.decode_plan).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fsm
from ..pipeline import Geometry, device_decode_fn


def _assemble_rows(per_lane: jnp.ndarray, layout, pad_to: int) -> jnp.ndarray:
    """[L, max_blk, ...] lane rows -> [pad_to, n_blocks_img, ...].

    Same slicing as fsm.assemble_batched, but traced inline so XLA fuses
    it into the consumer instead of materializing an intermediate.
    """
    tail = per_lane.shape[2:]
    per_img = []
    for first, n_lanes, rib, last in layout:
        rows = [
            per_lane[first : first + n_lanes - 1, :rib].reshape((-1,) + tail)
        ]
        rows.append(per_lane[first + n_lanes - 1, :last])
        per_img.append(jnp.concatenate(rows) if n_lanes > 1 else rows[-1])
    out = jnp.stack(per_img)
    if pad_to > out.shape[0]:
        pad = jnp.zeros((pad_to - out.shape[0],) + out.shape[1:], out.dtype)
        out = jnp.concatenate([out, pad])
    return out


@functools.lru_cache(maxsize=64)
def compiled_fused_decoder(
    geom: Geometry,
    tables: fsm.FsmTables,
    max_blk: int,
    layout: tuple,
    pad_to: int,
    fancy: bool = False,
    steps=fsm.STEPS_PRODUCTION,
    want_coeffs: bool = True,
    stop_after: str | None = None,
):
    """One jitted program: scan bytes [L, stride] -> rgb + risk + errors.

    Returns fn(xs, seg_n_blocks, quant) ->
      (rgb uint8 [B, 3, H, W], riskbits, coeffs [B, nb, 64] with RAW DC
       diffs, dc int32 [B, nb] resolved, err_mal [L], err_env [L],
       scan_state).

    coeffs+dc exist for the strict-repair path (risk pixels re-derive
    from exact coefficients); want_coeffs=False replaces them with None
    and saves their HBM writes (jit outputs cannot be dead-code
    eliminated).  scan_state is surfaced because XLA:CPU miscompiles
    scans with dead carry outputs (fsm._fsm_scan NB).

    stop_after: profiling hook ('scan' | 'materialize' | 'assemble') —
    truncates the program after that stage and returns a checksum that
    CONSUMES the stage's full output (so XLA cannot dead-code-eliminate
    or narrow it; a sliced fence measured a scan whose event buffer had
    been optimized away — tools/profile_fused.py).
    """

    def run(xs, seg_n_blocks, quant):
        with jax.named_scope("fsm_scan"):
            events, (err_mal, err_env), scan_state = fsm._fsm_scan(
                xs.T, seg_n_blocks, tables, steps=steps
            )
        stride, S, L = events.shape
        ev = events.reshape(stride * S, L)
        if stop_after == "scan":
            return ev.sum(), err_mal, err_env, scan_state
        M = max_blk * 64
        with jax.named_scope("materialize"):
            coeffs_t, err_mal = fsm.materialize_checked(ev, M, err_mal)
        if stop_after == "materialize":
            return coeffs_t.sum(), err_mal, err_env, scan_state
        with jax.named_scope("assemble"):
            per_lane = coeffs_t.T.reshape(L, max_blk, 64)
            dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], tables, max_blk)
            coeffs = _assemble_rows(per_lane, layout, pad_to)  # [B, nb, 64]
            dc = _assemble_rows(dc_lane, layout, pad_to)       # [B, nb]
        if stop_after == "assemble":
            return coeffs.sum() + dc.sum(), err_mal, err_env, scan_state
        with jax.named_scope("pixels"):
            rgb, risk = jax.vmap(
                lambda c, d, q: device_decode_fn(geom, c, q, fancy=fancy, dc=d)
            )(coeffs, dc, quant)
        if not want_coeffs:
            coeffs = dc = None
        return rgb, risk, coeffs, dc, err_mal, err_env, scan_state

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def compiled_superchunk_decoder(
    geom: Geometry,
    tables: fsm.FsmTables,
    max_blks: tuple,
    layouts: tuple,
    sub_lanes: tuple,
    pad_to: int,
    fancy: bool = False,
    steps=fsm.STEPS_PRODUCTION,
    want_coeffs: bool = True,
):
    """N chunks, ONE scan: the wide-scan fused program.

    Premise: the column scan's per-column cost grows sub-linearly in lane
    count while it is latency-bound, so scanning several chunks' lanes in
    one program divides the scan's serial cost between them, while the
    M-proportional stages (butterflies, pixel program), which scale
    linearly in width, run per chunk on event-matrix slices inside the
    same program.  Whether that premise holds on the GPU is recorded in
    PERF.md (bench.py --superchunk).

    Inputs: xs [sum(sub_lanes), stride] (sub-chunks concatenated, each
    padded to the common stride), seg_n likewise, quant [n_sub, B, C,
    64].  Returns per-sub stacked (rgb, risk, coeffs, dc) plus the
    combined error masks.
    """
    n_sub = len(layouts)

    def run(xs, seg_n_blocks, quant):
        events, (err_mal, err_env), scan_state = fsm._fsm_scan(
            xs.T, seg_n_blocks, tables, steps=steps
        )
        stride, S, L = events.shape
        ev = events.reshape(stride * S, L)
        rgbs, risks, coeffss, dcs, mals = [], [], [], [], []
        base = 0
        for si in range(n_sub):
            Ls = sub_lanes[si]
            ev_s = jax.lax.slice_in_dim(ev, base, base + Ls, axis=1)
            mal_s = jax.lax.slice_in_dim(err_mal, base, base + Ls)
            base += Ls
            max_blk = max_blks[si]
            M = max_blk * 64
            coeffs_t, mal_s = fsm.materialize_checked(ev_s, M, mal_s)
            mals.append(mal_s)
            per_lane = coeffs_t.T.reshape(Ls, max_blk, 64)
            dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], tables, max_blk)
            coeffs = _assemble_rows(per_lane, layouts[si], pad_to)
            dc = _assemble_rows(dc_lane, layouts[si], pad_to)
            rgb, risk = jax.vmap(
                lambda c, d, q: device_decode_fn(geom, c, q, fancy=fancy, dc=d)
            )(coeffs, dc, quant[si])
            rgbs.append(rgb)
            risks.append(risk)
            if want_coeffs:
                coeffss.append(coeffs)
                dcs.append(dc)
        rgb = jnp.concatenate(rgbs)
        risk = jnp.concatenate(risks)
        coeffs = jnp.concatenate(coeffss) if want_coeffs else None
        dc = jnp.concatenate(dcs) if want_coeffs else None
        err_mal = jnp.concatenate(mals)  # sub_lanes cover every lane
        return rgb, risk, coeffs, dc, err_mal, err_env, scan_state

    return jax.jit(run)


def pack_superchunk(plans: list, uploaded=None):
    """Concatenate N single-group plans into one wide lane matrix.

    Pads every sub-plan's rows to the max stride (zero columns are inert:
    lanes are done by then and never refill).  Returns (xs [Lw, stride],
    seg_n [Lw], sub_lanes tuple).  Host-side; callers device_put once.
    """
    stride = max(p.groups[0][0].shape[1] for p in plans)
    xs_parts, sn_parts, sub_lanes = [], [], []
    for p in plans:
        xs, sn = p.groups[0]
        if xs.shape[1] < stride:
            xs = np.pad(xs, ((0, 0), (0, stride - xs.shape[1])))
        xs_parts.append(xs)
        sn_parts.append(sn)
        sub_lanes.append(xs.shape[0])
    return (
        np.concatenate(xs_parts),
        np.concatenate(sn_parts),
        tuple(sub_lanes),
    )


def decode_superchunk(plans: list, quants, geom: Geometry, pad_to: int,
                      fancy: bool = False, steps=fsm.STEPS_PRODUCTION,
                      uploaded=None, want_coeffs: bool = True):
    """Run N single-group plans through the wide-scan program.

    quants: [n_sub, B, C, 64] device or host array.  `uploaded` is the
    device-put result of pack_superchunk (xs_dev, seg_n_dev)."""
    for p in plans:
        assert len(p.groups) == 1, "superchunk requires single-group plans"
    if uploaded is None:
        xs, sn, sub_lanes = pack_superchunk(plans)
        uploaded = (
            jax.device_put(jnp.asarray(xs)),
            jax.device_put(jnp.asarray(sn)),
        )
    else:
        sub_lanes = tuple(p.groups[0][0].shape[0] for p in plans)
    fn = compiled_superchunk_decoder(
        geom,
        plans[0].tables,
        tuple(p.max_blk for p in plans),
        tuple(p.layout for p in plans),
        sub_lanes,
        pad_to,
        fancy,
        steps,
        want_coeffs,
    )
    return fn(uploaded[0], uploaded[1], quants)


@functools.lru_cache(maxsize=64)
def compiled_spec_tail(
    geom: Geometry,
    tables: fsm.FsmTables,
    nb: int,
    pad_to: int,
    n_imgs: int,
    cap_w: int,
    fancy: bool = False,
    want_coeffs: bool = True,
):
    """Sync-spec tail, ONE program: adopt/merge events -> materialize ->
    int16 ragged gather (_spec_gather16_jit) -> pixel program with the
    resolved-DC side channel.  Fusing the gather into the pixel
    prologue's transposes removes a standalone full-tensor pass,
    mirroring what decode_chunk_fused does for the restart path."""

    def run(ev1, anchors, ablk, recm, ev2, end2, b1, blk2, quotas, quant):
        coeffs16, dc, err = fsm._spec_sync_assemble_jit(
            ev1, anchors, ablk, recm, ev2, end2, b1, blk2, quotas,
            tables=tables, pad_to=pad_to, nb=nb, n_imgs=n_imgs, cap_w=cap_w,
        )
        rgb, risk = jax.vmap(
            lambda c, d, q: device_decode_fn(geom, c, q, fancy=fancy, dc=d)
        )(coeffs16, dc, quant)
        if not want_coeffs:
            coeffs16 = dc = None
        return rgb, risk, coeffs16, dc, err

    return jax.jit(run)


def decode_spec_sync_fused(pending, geom: Geometry, quant, pad_to: int,
                           n_imgs: int, fancy: bool = False,
                           want_coeffs: bool = True):
    """Finish a spec_sync_start chunk through the fused tail.

    Raises SpecEnvelopeError / SpecSyncMiss via the shared host resolver
    (the one fetch, hidden when callers pipeline starts).  Returns
    (rgb, risk, coeffs16 raw-DC, dc, err_mask)."""
    plan = pending.plan
    quotas, cap_w = fsm.spec_sync_resolve_host(pending)
    fn = compiled_spec_tail(
        geom, plan.tables, int(plan.img_blocks[0]), pad_to, n_imgs,
        cap_w, fancy, want_coeffs,
    )
    return fn(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        jnp.asarray(quotas), quant,
    )


@functools.lru_cache(maxsize=64)
def compiled_fused_bucketed(
    bucket: Geometry,
    tables: fsm.FsmTables,
    max_blk: int,
    lanes_per_img: int,
    k: int,
    pad_to: int,
    fancy: bool = False,
    steps=fsm.STEPS_PRODUCTION,
    want_coeffs: bool = True,
):
    """One jitted program for a size-class bucket chunk of MIXED exact
    geometries: scan bytes -> bucket-raster rgb + risk + errors.

    The compile key carries only bucket-level statics — per-image
    variation (true MCU extents, real lane quotas, raster padding) rides
    as runtime vectors: quotas/wrap/skip drive the scan's bucket-raster
    emission (fsm._fsm_scan pad_info), so per_lane rows land directly in
    the bucket's padded layout and assembly is the static reshape below.
    This is the recompile-free mixed-size answer ON the flagship FSM
    path (reference any-size contract parser.cu:324-331).

    Returns fn(xs, seg_n, wrap_at, skip, quant, ext) ->
      (rgb uint8 [B, 3, Hb, Wb], riskbits, coeffs [B, nb_b, 64]
       RAW DC diffs, dc int32 [B, nb_b] resolved+masked, err_mal [L],
       err_env [L], scan_state).
    """
    bpm = bucket.blocks_per_mcu
    wb_bpm = bucket.mcus_x * bpm
    assert max_blk == k * wb_bpm
    nb_b = bucket.n_blocks
    need = pad_to * lanes_per_img

    def run(xs, seg_n, wrap_at, skip, quant, ext):
        events, (err_mal, err_env), scan_state = fsm._fsm_scan(
            xs.T, seg_n, tables, steps=steps, pad_info=(wrap_at, skip)
        )
        stride, S, L = events.shape
        ev = events.reshape(stride * S, L)
        M = max_blk * 64
        coeffs_t, err_mal = fsm.materialize_checked(ev, M, err_mal)
        per_lane = coeffs_t.T.reshape(L, max_blk, 64)
        dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], tables, max_blk)
        if need > L:
            per_lane = jnp.concatenate(
                [per_lane, jnp.zeros((need - L, max_blk, 64), per_lane.dtype)]
            )
            dc_lane = jnp.concatenate(
                [dc_lane, jnp.zeros((need - L, max_blk), dc_lane.dtype)]
            )
        # static bucket-raster assembly: lane rows ARE padded MCU rows
        rows = lanes_per_img * k
        coeffs = (
            per_lane[:need]
            .reshape(pad_to, rows, wb_bpm, 64)[:, : bucket.mcus_y]
            .reshape(pad_to, nb_b, 64)
        )
        dc = (
            dc_lane[:need]
            .reshape(pad_to, rows, wb_bpm)[:, : bucket.mcus_y]
            .reshape(pad_to, nb_b)
        )
        # padding slots' DC cumsum carries the predictor through gaps;
        # zero it outside each image's true extent so the pixel program
        # (and any fetched coefficients) see clean padding
        mcu = jnp.arange(nb_b, dtype=jnp.int32) // bpm
        row = mcu // bucket.mcus_x
        col = mcu % bucket.mcus_x
        real = (
            (row[None, :] < ext[:, 0:1]) & (col[None, :] < ext[:, 1:2])
        )
        dc = jnp.where(real, dc, 0)
        rgb, risk = jax.vmap(
            lambda c, d, q, e: device_decode_fn(
                bucket, c, q, fancy=fancy, dc=d, extents=(e[0], e[1])
            )
        )(coeffs, dc, quant, ext)
        if not want_coeffs:
            coeffs = dc = None
        return rgb, risk, coeffs, dc, err_mal, err_env, scan_state

    return jax.jit(run)


def decode_chunk_bucketed(plan: fsm.FsmBucketPlan, quant, bucket: Geometry,
                          pad_to: int, fancy: bool = False,
                          steps=fsm.STEPS_PRODUCTION, uploaded=None,
                          want_coeffs: bool = True):
    """Run a bucket plan through the fused bucketed program.  `uploaded`
    is (xs_dev, seg_n_dev, wrap_dev, skip_dev) to skip the host upload."""
    if uploaded is None:
        uploaded = tuple(
            jax.device_put(jnp.asarray(a))
            for a in (plan.xs, plan.seg_n, plan.wrap_at, plan.skip)
        )
    ext = np.zeros((pad_to, 2), np.int32)
    ext[: plan.n_imgs] = plan.extents
    fn = compiled_fused_bucketed(
        bucket, plan.tables, plan.max_blk, plan.lanes_per_img, plan.k,
        pad_to, fancy, steps, want_coeffs,
    )
    return fn(*uploaded, quant, jnp.asarray(ext))


def decode_chunk_fused(plan: fsm.FsmPlan, quant, geom: Geometry, pad_to: int,
                       fancy: bool = False, steps=fsm.STEPS_PRODUCTION,
                       uploaded=None, want_coeffs: bool = True):
    """Convenience wrapper: run a single-group plan through the fused
    program.  `uploaded` is (xs_dev, seg_n_dev) to skip the host upload
    (the kernel-only benchmark methodology)."""
    assert len(plan.groups) == 1, "fused path requires a single-group plan"
    if uploaded is None:
        xs, sn = plan.groups[0]
        uploaded = (jax.device_put(jnp.asarray(xs)),
                    jax.device_put(jnp.asarray(sn)))
    fn = compiled_fused_decoder(
        geom, plan.tables, plan.max_blk, plan.layout, pad_to, fancy, steps,
        want_coeffs,
    )
    return fn(uploaded[0], uploaded[1], quant)
