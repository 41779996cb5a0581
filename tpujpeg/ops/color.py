"""YCbCr -> RGB conversion with exactness-risk flagging.

Reference semantics (cpp color.cpp:8-19 / cuda parser.cu:566-573) use double
intermediates rounded once per channel to float32, then a truncating int
cast and clamp to [0,255].  The device computes in f32 and flags pixels
whose value lands within EPS of a truncation boundary; the host repairs
flagged pixels with the exact oracle math (it owns the coefficients, so
repair costs a few vectorized 8x8 IDCTs).

Exactness budget (tools/check_color_risk.py, exhaustive over the full
reachable domain [-256,255]^3 — IDCT output is clipped there):
  - R and B: the f32 formula is bit-exact everywhere (0/134M mismatches).
  - G: max |f32 - oracle| = 1.23e-4; all 281 truncation flips lie within
    3.1e-5 of a boundary.
EPS = 1e-3 gives an 8x margin over the worst observed deviation and also
absorbs compiler rounding differences (e.g. FMA contraction, which
contributes at most ~1 extra ulp); flagged fraction is ~0.2%/channel.
tools/check_color_device.py re-proves the bound against the kernel the
current backend compiles (PERF.md records the GPU run).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import C_BLUE, C_GY_B, C_GY_DIV, C_GY_R, C_RED

EPS = np.float32(1e-3)

_F_RED = np.float32(C_RED)
_F_BLUE = np.float32(C_BLUE)
_F_GY_B = np.float32(C_GY_B)
_F_GY_R = np.float32(C_GY_R)
_F_GY_INV = np.float32(1.0 / C_GY_DIV)
_F_128 = np.float32(128.0)


def color_core(
    y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray
) -> tuple[list[jnp.ndarray], jnp.ndarray]:
    """The exact f32 conversion: int planes -> ([r, g, b] int32 in
    [0, 255], risky bool).

    Kept dtype-neutral (int32 out, no uint8 cast): ONE definition of the
    math the exactness proof covers, whatever layout the caller wants.
    """
    yf = y.astype(jnp.float32)
    r = _F_RED * cr.astype(jnp.float32) + yf
    b = _F_BLUE * cb.astype(jnp.float32) + yf
    g = (yf - _F_GY_B * b - _F_GY_R * r) * _F_GY_INV

    rgb = []
    risky = None
    for ch in (r, g, b):
        shifted = ch + _F_128
        trunc = jnp.trunc(shifted)
        dist = jnp.abs(shifted - jnp.round(shifted))
        flag = dist < EPS
        risky = flag if risky is None else (risky | flag)
        rgb.append(jnp.clip(trunc.astype(jnp.int32), 0, 255))
    return rgb, risky


def color_channels(
    y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray
) -> tuple[list[jnp.ndarray], jnp.ndarray]:
    """Shared core: int planes -> ([r, g, b] uint8 list, risky bool).

    Channels are returned UNstacked so callers choose the layout: the
    planar device pipeline stacks them on a LEADING axis, keeping the
    long pixel axis minor.
    """
    rgb, risky = color_core(y, cb, cr)
    return [ch.astype(jnp.uint8) for ch in rgb], risky


def ycbcr_to_rgb(
    y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Convert int32 planes to (rgb uint8 [..., 3], risky bool [...]).

    `risky` marks pixels where any channel's pre-truncation value sits
    within EPS of an integer boundary — the only places the f32 result can
    disagree with the reference's mixed-precision math.  Interleaved
    output is for host-facing helpers; the device pipeline uses
    :func:`color_channels` + a leading stack instead.
    """
    rgb, risky = color_channels(y, cb, cr)
    return jnp.stack(rgb, axis=-1), risky


def pack_mask(mask: jnp.ndarray) -> jnp.ndarray:
    """Pack a [..., W] bool mask into [..., W/8] uint8 (W padded to 8).

    Keeps the device->host transfer for the repair mask at 1 bit/pixel.
    """
    w = mask.shape[-1]
    pad = (-w) % 8
    if pad:
        mask = jnp.pad(mask, [(0, 0)] * (mask.ndim - 1) + [(0, pad)])
    m = mask.reshape(mask.shape[:-1] + (-1, 8)).astype(jnp.uint8)
    weights = (1 << np.arange(8, dtype=np.uint8)).astype(np.uint8)
    return (m * weights).sum(axis=-1).astype(jnp.uint8)


def unpack_mask(packed: np.ndarray, width: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_mask` -> bool [..., width]."""
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits[..., :width].astype(bool)
