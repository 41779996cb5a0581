"""Multi-chip decode: batch sharding and MCU-stripe sharding over a Mesh.

The reference is single-GPU/single-process (SURVEY §2.7); its batch layer is
`batchDecodeKernel<<<B,256>>>` mapping blockIdx.x -> image
(cuda-decoder/src/parser.cu:663-682).  The mesh equivalents:

- **Batch (data) parallelism**: a size-bucketed batch of coefficient arrays
  is sharded over the `batch` mesh axis with shard_map; each chip runs the
  same single-image decode program vmapped over its local shard.  The only
  collective is a psum of decode metrics.

- **MCU-stripe (sequence) parallelism**: one huge image's MCU rows are
  sharded over the `stripe` axis.  Dequant/IDCT/color are per-block or
  per-pixel, and for box upsampling each output row depends only on its own
  MCU row, so stripes compute locally and the full image is materialized
  with an all_gather along `stripe`.  This is the decode analog of
  sequence parallelism; halo exchange slots in here when fancy
  (triangle-filter) upsampling is added.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..pipeline import Geometry, device_decode_fn


def make_mesh(n_batch: int | None = None, n_stripe: int = 1, devices=None) -> Mesh:
    """Build a (batch, stripe) mesh over the available devices.

    When n_batch is given and n_batch * n_stripe is smaller than the
    device count, the mesh uses the first n_batch * n_stripe devices.
    """
    devices = np.array(devices if devices is not None else jax.devices())
    if n_batch is None:
        n_batch = devices.size // n_stripe
    return Mesh(
        devices[: n_batch * n_stripe].reshape(n_batch, n_stripe),
        ("batch", "stripe"),
    )


# ---------------------------------------------------------------------------
# Batch-parallel decode
# ---------------------------------------------------------------------------


def batched_decode_fn(
    geom: Geometry, coeffs: jnp.ndarray, quant: jnp.ndarray,
    fancy: bool = False, extents: jnp.ndarray | None = None,
):
    """vmapped single-image decode: [B, n_blocks, 64] -> ([B,H,W,3], [B,...]).

    extents: optional [B, 2] int32 (true_mcus_y, true_mcus_x) per image
    when `geom` is a size-class bucket (pipeline.bucket_geometry).
    """
    if extents is None:
        return jax.vmap(functools.partial(device_decode_fn, geom, fancy=fancy))(
            coeffs, quant
        )
    return jax.vmap(
        lambda c, q, e: device_decode_fn(
            geom, c, q, fancy=fancy, extents=(e[0], e[1])
        )
    )(coeffs, quant, extents)


@functools.lru_cache(maxsize=64)
def compiled_batch_decoder(
    geom: Geometry, mesh: Mesh, fancy: bool = False, bucketed: bool = False
):
    """jit a batch decode sharded over the `batch` mesh axis.

    Inputs must have a leading batch dim divisible by the batch axis size.
    Returns (rgb, riskbits, metrics) with metrics = global decoded-pixel
    count (psum over the mesh — the cross-chip reduction the reference's
    benchmark layer does on host).

    bucketed=True compiles the size-class form: `geom` is a bucket
    (pipeline.bucket_geometry), the call takes a third [B, 2] int32
    true-MCU-extent argument, and rgb/risk cover the bucket's padded
    raster (callers crop per image on host).  One compile then serves
    EVERY exact geometry in the class — the recompile-free answer to the
    reference's runtime-value dims (parser.cu:324-331).
    """

    def step(coeffs, quant, extents=None):
        def local(coeffs_l, quant_l, extents_l=None):
            rgb, risk = batched_decode_fn(
                geom, coeffs_l, quant_l, fancy=fancy, extents=extents_l
            )
            pixels = jnp.asarray(
                rgb.shape[0] * geom.width * geom.height, dtype=jnp.int32
            )
            total = jax.lax.psum(pixels, axis_name="batch")
            return rgb, risk, total

        if extents is None:
            return jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P("batch"), P("batch")),
                out_specs=(P("batch"), P("batch"), P()),
                check_vma=False,
            )(coeffs, quant)
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("batch"), P("batch"), P("batch")),
            out_specs=(P("batch"), P("batch"), P()),
            check_vma=False,
        )(coeffs, quant, extents)

    if bucketed:
        return jax.jit(step)
    return jax.jit(lambda coeffs, quant: step(coeffs, quant))


# ---------------------------------------------------------------------------
# Stripe-parallel decode of one huge image
# ---------------------------------------------------------------------------


def stripe_geometry(geom: Geometry, n_stripes: int) -> Geometry:
    """Geometry of one horizontal stripe of `geom` (mcus_y split evenly)."""
    if geom.mcus_y % n_stripes:
        raise ValueError(f"mcus_y={geom.mcus_y} not divisible by {n_stripes}")
    rows = geom.mcus_y // n_stripes
    return Geometry(
        (geom.width, rows * 8 * geom.max_v, geom.mcus_x, rows, geom.comps)
    )


def _halo_extend_rows(plane: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Prepend/append 1 row of the neighboring stripes' plane (ppermute).

    At the global top/bottom the local edge row is replicated instead —
    exactly the edge rule the unsharded triangle filter applies, so the
    sharded result is bit-identical to the single-chip one.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top, bot = plane[:1], plane[-1:]
    # row arriving from the stripe above (their bottom row) and below (top)
    from_above = jax.lax.ppermute(
        bot, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
    )
    from_below = jax.lax.ppermute(
        top, axis_name, perm=[(i + 1, i) for i in range(n - 1)]
    )
    halo_top = jnp.where(idx == 0, top, from_above)
    halo_bot = jnp.where(idx == n - 1, bot, from_below)
    return jnp.concatenate([halo_top, plane, halo_bot], axis=0)


def _stripe_upsample(
    sub: Geometry, planes: list[jnp.ndarray], fancy: bool, axis_name: str
) -> list[jnp.ndarray]:
    """Upsample stripe-local planes; fancy vertical filters exchange halos.

    The triangle filter's even/odd output rows read the chroma row above/
    below (ops/upsample.py), so a stripe's first and last output row pairs
    need 1 row from the neighboring stripes — the halo exchange this build
    was designed for (SURVEY §8 hard-part #5).  Box needs no halos.
    """
    from ..ops.upsample import fancy_upsample, upsample_plane

    out = []
    for p, (h, v, _) in zip(planes, sub.comps):
        fh, fv = sub.max_h // h, sub.max_v // v
        if not (fancy and fv == 2 and fh <= 2):
            out.append(upsample_plane(p, fh, fv, fancy))
            continue
        samples = jnp.clip(p + 128, 0, 255)
        ext = _halo_extend_rows(samples, axis_name)
        up = fancy_upsample(ext, fh, fv)
        # drop the halo rows' own outputs (2 rows top and bottom)
        out.append(up[2:-2] - 128)
    return out


@functools.lru_cache(maxsize=64)
def compiled_stripe_decoder(geom: Geometry, mesh: Mesh, fancy: bool = False):
    """jit a single-image decode with MCU rows sharded over `stripe`.

    coeffs [n_blocks, 64] is sharded by block (MCU-row-major order means an
    even block split == an even MCU-row split); each chip decodes its stripe
    of rows locally, then the stripes are all_gathered into the full frame.
    The stripe height is a multiple of the MCU height, so box upsampling is
    stripe-local; fancy (triangle) upsampling exchanges 1-row chroma halos
    (`_stripe_upsample`) and stays bit-identical to the unsharded
    decode.
    """
    from ..pipeline import decode_subsampled_planes, planes_to_rgb

    n_stripes = mesh.shape["stripe"]
    sub = stripe_geometry(geom, n_stripes)

    def step(coeffs, quant):
        def local(coeffs_l, quant_l):
            planes = decode_subsampled_planes(sub, coeffs_l, quant_l)
            planes = _stripe_upsample(sub, planes, fancy, "stripe")
            rgb, risk = planes_to_rgb(sub, planes)
            # rgb is planar [3, h_stripe, W]: stripes tile on the H axis
            rgb_full = jax.lax.all_gather(rgb, "stripe", axis=1, tiled=True)
            risk_full = jax.lax.all_gather(risk, "stripe", axis=0, tiled=True)
            return rgb_full, risk_full

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("stripe"), P()),
            out_specs=(P(), P()),
            # all_gather(tiled) leaves outputs replicated over `stripe`;
            # disable the varying-axes check that can't see that.
            check_vma=False,
        )(coeffs, quant)

    return jax.jit(step)


def decode_striped(
    img,
    n_stripes: int | None = None,
    mesh: Mesh | None = None,
    strict: bool = True,
    fancy: bool = False,
):
    """Decode one image with its MCU rows sharded across chips.

    Host entropy decode -> stripe-sharded device pipeline -> [H, W, 3],
    bit-exact (strict repairs flagged color-boundary pixels, as in
    pipeline.decode).  fancy=True upsamples chroma with the triangle
    filter, exchanging 1-row halos between stripes.
    """
    from ..ops.color import unpack_mask
    from ..pipeline import _repair, build_plan

    geom, coeffs, quant = build_plan(img)
    if mesh is None:
        mesh = make_mesh(n_batch=1, n_stripe=n_stripes or len(jax.devices()))
    fn = compiled_stripe_decoder(geom, mesh, fancy)
    rgb, risk = fn(jnp.asarray(coeffs), jnp.asarray(quant))
    rgb = np.ascontiguousarray(
        np.moveaxis(np.asarray(jax.device_get(rgb)), 0, -1)
    ).astype(np.int32)[: img.height]
    if strict:
        mask = unpack_mask(np.asarray(jax.device_get(risk)), img.width)[: img.height]
        if mask.any():
            _repair(img, coeffs, rgb, mask, fancy=fancy)
    return rgb
